"""Exclusive Feature Bundling (EFB) — host-side preprocessing.

Re-creates the behavior of the reference's bundling pass
(src/io/dataset.cpp:111 FindGroups, :250 FastFeatureBundling): sparse,
(nearly) mutually-exclusive features are merged into one bin column so
the per-column histogram cost drops from O(#features) to O(#bundles).

Device formulation: the device bin matrix stays ONE dense feature-major
int matrix — bundling just shrinks its leading axis. Each bundle
column stores, per row, the offset-shifted bin of whichever member
feature is away from its most-frequent bin (0 = "every member at its
most-frequent bin"). Split finding still runs per ORIGINAL feature:
bundle histograms are expanded back to per-feature layout with a
gather, and each feature's most-frequent-bin slot is recovered from the
leaf totals minus the stored bins — exactly the reference's
FixHistogram trick (include/LightGBM/dataset.h:768), which exists for
the same reason (the most-frequent bin is not stored).

Grouping mirrors FindGroups' greedy pass: features ordered by
non-default count descending (dense first), each placed in the first
group where the conflict count stays within the global budget
(total_rows / 10000) and half the feature's own non-default count,
with a per-group merged-width cap so the uniform device bin axis does
not grow.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .binning import BinMapper, BinType

# reference dataset.cpp FindGroups constants
MAX_SEARCH_GROUP = 100


class BundleLayout(NamedTuple):
    """Host description of the feature -> bundle-column mapping.

    All per-feature arrays are indexed by USED-feature position (the
    grower's feature axis). Singleton columns store original bins
    directly (mfb == -1, off_lo == 0).
    """

    groups: List[List[int]]  # used-feature positions per bundle column
    bundle_of: np.ndarray  # (F,) int32 — device column of each feature
    off_lo: np.ndarray  # (F,) int32 — merged-range start within the column
    mfb: np.ndarray  # (F,) int32 — excluded most-freq bin; -1 = stored direct
    col_bins: int  # uniform device bin-axis size B' (max column width)

    @property
    def num_columns(self) -> int:
        return len(self.groups)

    def is_trivial(self) -> bool:
        """True when every group is a singleton (no merging happened)."""
        return all(len(g) == 1 for g in self.groups)


def find_groups(
    bins: np.ndarray,  # (F, N) full binned matrix (used features)
    num_bins: Sequence[int],
    most_freq: Sequence[int],
    is_cat: Sequence[bool],
    max_group_bins: int,
) -> List[List[int]]:
    """Greedy conflict-bounded grouping (reference FindGroups semantics).

    Categorical features never merge (their bin identity is a category;
    the sorted-subset scan assumes a dedicated column).
    """
    F, N = bins.shape
    budget = N // 10000  # single_val_max_conflict_cnt
    nd_masks = [bins[f] != most_freq[f] for f in range(F)]
    nd_cnt = np.array([int(m.sum()) for m in nd_masks])
    # dense first, like FastFeatureBundling's sort by non-zero count
    order = np.argsort(-nd_cnt, kind="stable")

    groups: List[List[int]] = []
    group_mask: List[np.ndarray] = []
    group_bins: List[int] = []
    group_conflict: List[int] = []
    group_has_cat: List[bool] = []
    for f in order:
        f = int(f)
        width = int(num_bins[f]) - 1  # mfb slot excluded once merged
        placed = False
        if not is_cat[f] and nd_cnt[f] < N:  # fully-dense features never merge
            # cap the candidate-group search like the reference
            # (max_search_group, dataset.cpp:117) — without it, wide
            # sparse data pays O(F x G x N) host preprocessing
            searched = 0
            for gid in range(len(groups)):
                if searched >= MAX_SEARCH_GROUP:
                    break
                # a group founded by a categorical feature stays a
                # dedicated column both ways: the categorical never
                # merges INTO a group, and no numeric feature merges
                # into ITS group (build_layout would offset-encode the
                # categorical column, breaking the bin==category
                # identity the sorted-subset scan relies on)
                if group_has_cat[gid]:
                    continue
                if group_bins[gid] + width > max_group_bins:
                    continue
                rest = budget - group_conflict[gid]
                if rest < 0:
                    continue
                searched += 1
                cnt = int(np.sum(group_mask[gid] & nd_masks[f]))
                if cnt <= rest and cnt <= nd_cnt[f] // 2:
                    groups[gid].append(f)
                    group_mask[gid] |= nd_masks[f]
                    group_bins[gid] += width
                    group_conflict[gid] += cnt
                    placed = True
                    break
        if not placed:
            groups.append([f])
            group_mask.append(nd_masks[f].copy())
            # a solo feature keeps its full bin range (incl. mfb)
            group_bins.append(1 + width)
            group_conflict.append(0)
            group_has_cat.append(bool(is_cat[f]))
    return groups


def find_groups_sparse(
    nd_rows: List[Optional[np.ndarray]],  # sorted non-default row ids, or
    # None when the feature must stay a dedicated column
    num_bins: Sequence[int],
    n_rows: int,
    max_group_bins: int,
) -> List[List[int]]:
    """find_groups over sparse features (the CSR path; dataset.cpp:111
    FindGroups semantics): the JAX package's greedy pass and its groups,
    with each group's rows held as a bitset of n_rows bits, so a conflict
    count is a gather of the feature's own rows (O(its rows), where the
    JAX package intersects sorted row lists, O(the group's rows)) and no
    (F, N) boolean mask is ever built. Features whose nd_rows is None
    (categorical, dense, most frequent bin not the zero bin) found
    singleton groups that accept no members."""
    budget = n_rows // 10000
    cnts = np.array(
        [n_rows if r is None else len(r) for r in nd_rows], np.int64
    )
    order = np.argsort(-cnts, kind="stable")
    nbytes = (n_rows + 7) // 8
    groups: List[List[int]] = []
    group_bits: List[Optional[np.ndarray]] = []
    group_bins: List[int] = []
    group_conflict: List[int] = []
    for f in order:
        f = int(f)
        width = int(num_bins[f]) - 1
        placed = False
        rows = nd_rows[f]
        if rows is not None:
            rows = np.asarray(rows, np.int64)
            byte, bit = rows >> 3, (rows & 7).astype(np.uint8)
            mask = np.left_shift(1, bit).astype(np.uint8)
        if rows is not None and cnts[f] < n_rows:
            searched = 0
            for gid in range(len(groups)):
                if searched >= MAX_SEARCH_GROUP:
                    break
                if group_bits[gid] is None:
                    continue  # founded by an unmergeable feature
                if group_bins[gid] + width > max_group_bins:
                    continue
                rest = budget - group_conflict[gid]
                if rest < 0:
                    continue
                searched += 1
                cnt = int(np.count_nonzero(
                    (group_bits[gid][byte] >> bit) & 1))
                if cnt <= rest and cnt <= cnts[f] // 2:
                    groups[gid].append(f)
                    np.bitwise_or.at(group_bits[gid], byte, mask)
                    group_bins[gid] += width
                    group_conflict[gid] += cnt
                    placed = True
                    break
        if not placed:
            groups.append([f])
            bits = None
            if rows is not None:
                bits = np.zeros(nbytes, np.uint8)
                np.bitwise_or.at(bits, byte, mask)
            group_bits.append(bits)
            group_bins.append(1 + width)
            group_conflict.append(0)
    return groups


def build_layout(
    groups: List[List[int]],
    num_bins: Sequence[int],
) -> BundleLayout:
    F = len(num_bins)
    bundle_of = np.zeros(F, np.int32)
    off_lo = np.zeros(F, np.int32)
    mfb = np.full(F, -1, np.int32)
    col_bins = 1
    for gid, feats in enumerate(groups):
        if len(feats) == 1:
            f = feats[0]
            bundle_of[f] = gid
            col_bins = max(col_bins, int(num_bins[f]))
            continue
        off = 1  # merged bin 0 = all members at their most-freq bin
        for f in feats:
            bundle_of[f] = gid
            off_lo[f] = off
            off += int(num_bins[f]) - 1
        col_bins = max(col_bins, off)
    return BundleLayout(
        groups=groups,
        bundle_of=bundle_of,
        off_lo=off_lo,
        mfb=np.full(F, -1, np.int32),  # filled by encode()
        col_bins=col_bins,
    )


def encode(
    bins: np.ndarray,  # (F, N) per-feature bins
    layout: BundleLayout,
    num_bins: Sequence[int],
    most_freq: Sequence[int],
    dtype=np.int32,
) -> Tuple[np.ndarray, BundleLayout]:
    """Merge per-feature bin columns into bundle columns.

    Conflicting rows (two members away from default — within the
    counted budget) resolve to the LAST member written, matching the
    reference's push-order overwrite.
    """
    F, N = bins.shape
    G = layout.num_columns
    out = np.zeros((G, N), dtype=dtype)
    mfb = np.full(F, -1, np.int32)
    for gid, feats in enumerate(layout.groups):
        if len(feats) == 1:
            out[gid] = bins[feats[0]]
            continue
        col = out[gid]
        for f in feats:
            m = int(most_freq[f])
            mfb[f] = m
            b = bins[f]
            nd = b != m
            shifted = b[nd].astype(np.int64) - (b[nd] > m)
            col[nd] = (layout.off_lo[f] + shifted).astype(dtype)
    return out, layout._replace(mfb=mfb)


def build_expand_idx(
    layout: BundleLayout, num_bins: Sequence[int], feat_bins: int
) -> np.ndarray:
    """(F, feat_bins) flat gather index into the (G * col_bins) bundle
    histogram for each (feature, bin); -1 marks the most-freq slot
    (recovered by subtraction) and out-of-range bins."""
    F = len(num_bins)
    Bc = layout.col_bins
    idx = np.full((F, feat_bins), -1, np.int32)
    for f in range(F):
        g = int(layout.bundle_of[f])
        nb = int(num_bins[f])
        m = int(layout.mfb[f])
        for b in range(nb):
            if m < 0:  # direct storage
                idx[f, b] = g * Bc + b
            elif b != m:
                idx[f, b] = g * Bc + int(layout.off_lo[f]) + b - (b > m)
    return idx


def bundle_features(
    bins: np.ndarray,
    mappers: List[BinMapper],
    max_bin: int,
    dtype=np.int32,
) -> Optional[Tuple[np.ndarray, BundleLayout, np.ndarray]]:
    """Full EFB pass over the binned (used-feature) matrix.

    Returns (merged_bins (G, N), layout, expand_idx (F, Bf)) or None
    when no merging is possible (all groups singleton) — caller keeps
    the plain per-feature matrix with zero overhead.
    """
    num_bins = [m.num_bin for m in mappers]
    most_freq = [m.most_freq_bin for m in mappers]
    is_cat = [m.bin_type == BinType.CATEGORICAL for m in mappers]
    max_group_bins = max(max_bin + 1, 256)
    groups = find_groups(bins, num_bins, most_freq, is_cat, max_group_bins)
    if all(len(g) == 1 for g in groups):
        return None
    layout = build_layout(groups, num_bins)
    merged, layout = encode(bins, layout, num_bins, most_freq, dtype)
    feat_bins = max(num_bins)
    expand_idx = build_expand_idx(layout, num_bins, feat_bins)
    return merged, layout, expand_idx
