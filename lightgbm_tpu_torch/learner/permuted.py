"""Leaf-wise tree growth over a physically permuted bin matrix: the
sequential grower behind tpu_growth_mode=exact, with its batched round
phase (tpu_growth_rounds).

The port of lightgbm_tpu/learner/permuted.py (grow_tree_permuted) for
one device. The bin matrix, the f32 channels and a row-origin vector are
kept reordered so that every leaf owns one contiguous segment
[begin, begin + count) (the reference's data_partition.hpp). A split
then costs O(segment):
- a stable partition of the parent segment: left rows in their order,
  then right rows, placed by an exclusive prefix sum of the go-left
  flags (no sort, no nonzero: nothing waits for the host);
- the smaller child's histogram over its segment (histogram.histogram:
  the hist kernel on the card, which reads the segment's bounds from
  device memory), the larger child by parent subtraction;
- the best splits of both children in one batched search.

Everything the loop reads lives on the device: the split counter, the
segment bounds, the tree's links, parents and depths. Its loops are the
JAX package's (`cond` / `body`, `_round_cond` / `_round_body`) written
once for the three modes of learner/device_loop.py:
- the sequential phase is L - 1 split steps, each a no-op once no gain
  is positive and no forced entry applies (it then writes only the dump
  rows past the tree: node L - 1 and leaf L, which are never read for a
  real leaf);
- the round phase (spec.rounds) splits every positive-gain leaf at
  once, over S = L // 2 + 1 slots, while the leaf budget holds (the
  budget guard of permuted.py:521): one multi-leaf stable partition of
  all N rows through two exclusive prefix sums, and one hist_slots call
  for all smaller children. A bounded loop runs round_phase_cap(L)
  rounds; a tree still splitting at the cap is grown again on the eager
  loop (boosting.fused_collect).
The eager loop reads its predicate once a split (or round) and a split's
segment size once.

The partition of a split works on a window of static width: the
segment-capacity ladder of the JAX package (segment_caps, lax.switch
over mk_part). Each capacity is a body that gathers the window [start,
start + cap) at the device begin, partitions the segment inside it and
scatters it back; DeviceLoop.ladder runs the smallest capacity that
holds the segment (EAGER: chosen on the host; CAPTURE: each body under
an IF node on the device's count; BOUNDED: the widest, which holds every
segment). The bodies move the same rows to the same places, so the
capacity changes no bit. The smaller child's histogram needs no ladder:
the hist kernel reads its bounds from device memory, and its fixed-point
scale is taken at n = N // 2 (the most rows a smaller child holds) on
every split, eager or fused.

A row of a categorical split goes left iff its bin is in the split's
category set (cat_mask), in both phases (permuted.py _go_left, :367-372);
the histogram kernels do not depend on the split type.

The per-node extras (grower.make_node_candidates) draw the candidates
of a split's two children in one batch, salts 2 i + 1 and 2 i + 2 at
split i, i the device split counter (permuted.py:813-840), and a
forced-split plan (:559-622) takes the first n splits at their
prescribed leaves while an entry leaves both children non-empty, its
entry chosen on the device by the split counter. Neither combines with
the round phase (permuted.py:212-213, as in the JAX package).

Monotone intermediate (spec.mono_mode 1, permuted.py:841-918) keeps
every leaf's ancestry ((L, L-1) bools on the device) and, after each
split, takes every leaf's bounds from grower.mono_bounds and searches
every live leaf's best split again under them in one batch: device
work inside the split. It excludes the round phase, the per-node extras
and a forced plan, as in the JAX package (boosting falls back or turns
the round phase off); advanced becomes intermediate on this grower
(boosting, with a warning).

Monotone basic, NaN default-left, max_depth, EFB bundles and
categorical splits are kept.

Two mesh axes (parallel.comm.Mesh):
- a data axis (spec.axis_name; permuted.py:407-408, :435, :719,
  :774-791 of the JAX package): each rank partitions its own rows; the
  root sums are reduced, the smaller child is chosen on the global row
  counts, and every histogram crosses the wire as int64 fixed-point
  partials taken at the scale one device holding every row would take
  (the channel maxima over every rank, n from spec.axis_rows), so the
  reduced sums are that device's bits and N ranks grow the serial tree
  bit for bit. Under spec.voting_k each split elects 2k columns from
  the ranks' local gains on the smaller child and reduces only those
  (hist_valid marks the stored columns that hold global sums);
- a feature axis (spec.feature_axis: every rank holds every row and
  every bin, feature_parallel_tree_learner.cpp): each rank builds and
  searches only its own block of ceil(G / n) columns, and the winner is
  an all-gather argmax whose ties go to the lowest rank (the lowest
  feature, as one device's search picks); the partition is local and
  the same on every rank. No histogram crosses the wire.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .bundle import BundleInfo, decode_feature_bins, expand_hist
from .device_loop import DeviceLoop
from .grower import (
    CegbInfo,
    ForcedSplits,
    GrowerSpec,
    TreeArrays,
    empty_tree,
    forced_record,
    make_node_candidates,
    mono_bounds,
    monotone_child_intervals,
    select_global_rec,
    split_leaf_outputs,
)
from .histogram import build_gh3, fx_axis_absmax, fx_axis_reduce, \
    fx_exponents, fx_to_f32, hist_slots, histogram, root_sums
from .split import BIG, NEG_INF, SplitParams, SplitRecord, best_split, \
    cumsum_last, feature_best_gains, first_argmax, leaf_output, map_record

# the narrowest window of the segment ladder (the JAX package stops at
# its 2048-row block; a narrower floor costs two graph nodes a split per
# step and lets small data reach several capacities)
SEG_CAP_MIN = 128


def segment_caps(n_rows: int) -> Tuple[int, ...]:
    """The ladder of segment capacities: N, N / 2, ... down to the last
    one >= SEG_CAP_MIN (the JAX package's segment_caps at its own
    floor); N alone when N is smaller."""
    caps, c = [], int(n_rows)
    while c >= SEG_CAP_MIN:
        caps.append(c)
        c //= 2
    return tuple(caps) or (int(n_rows),)


def round_phase_cap(num_leaves: int) -> int:
    """The rounds a bounded loop gives the round phase: a round splits
    every positive-gain leaf, so a tree whose leaves keep splitting is
    done in log2(L) + 1 rounds; twice that plus 8 leaves room for rounds
    that split few (a 255-leaf Higgs-like tree takes ~7 of the 24)."""
    return 2 * max(int(num_leaves) - 1, 1).bit_length() + 8


def _excl_prefix(x: torch.Tensor) -> torch.Tensor:
    """(N,) bool -> (N + 1,) int64 exclusive prefix sums."""
    cs = torch.cumsum(x.to(torch.int64), dim=0)
    return torch.cat([torch.zeros(1, dtype=torch.int64, device=x.device), cs])


def _put(dst: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> None:
    """dst[idx] = val in place along the first axis; the dump rows take
    the writes of idle splits and slots."""
    dst.index_put_((idx,), val)


class _Grower:
    """State of one tree, on the device. Every table carries one row past
    the tree's (node L - 1, leaf L): the dump rows that idle steps write,
    which no live leaf reads. Every update is in place, so a step that a
    replay skips leaves the state as it found it."""

    def __init__(self, bins_fm, nan_bin, num_bins, mono, is_cat, grad, hess,
                 mask, feat_mask, params: SplitParams, spec: GrowerSpec,
                 valid, bundle: Optional[BundleInfo], rng_key=None,
                 group_mat=None, cegb: Optional[CegbInfo] = None,
                 forced: Optional[ForcedSplits] = None):
        L, B = spec.num_leaves, spec.num_bins
        G, N = bins_fm.shape
        dev = bins_fm.device
        self.L, self.N, self.dev = L, N, dev
        self.Bc = spec.col_bins if (spec.efb and spec.col_bins) else B
        self.spec, self.params = spec, params
        self.nan_bin, self.num_bins, self.mono = nan_bin, num_bins, mono
        # a dataset without categorical features skips their search
        self.is_cat = is_cat if spec.has_cat else None
        self.feat_mask, self.bundle = feat_mask, bundle
        self.has_mono = spec.has_mono
        self.forced = forced
        self.caps = segment_caps(N)
        # the smaller child's histogram: the most rows it can hold sizes
        # the launch and the fixed-point scale on every split
        self.hist_cap = max(N // 2, 1)
        # ---- mesh axes (module docstring)
        self.ax, self.fax = spec.axis_name, spec.feature_axis
        self.axis_rows = spec.axis_rows or N
        self.voting = bool(spec.voting_k) and self.ax is not None
        self.nb_t, self.nan_t, self.mono_t = num_bins, nan_bin, mono
        self.iscat_t = self.is_cat
        self.Gh = G  # histogram pool columns
        if self.fax is not None:
            if spec.efb or spec.per_node or spec.n_forced or spec.mono_mode:
                raise ValueError("a feature axis takes plain columns: no "
                                 "EFB, per-node extras, forced plan or "
                                 "monotone refinement")
            n = self.fax.size
            Fb = -(-G // n)
            lo = self.fax.rank * Fb
            self.blk = (lo, min(lo + Fb, G), Fb)
            self.Gh = Fb

            def my_block(t, fill):
                pad = torch.full((n * Fb - G,) + tuple(t.shape[1:]), fill,
                                 dtype=t.dtype, device=dev)
                return torch.cat([t, pad])[lo:lo + Fb]

            self.nb_t, self.nan_t = my_block(num_bins, 0), \
                my_block(nan_bin, -1)
            self.mono_t = my_block(mono, 0)
            self.fm_t = my_block(feat_mask, False)
            if self.is_cat is not None:
                self.iscat_t = my_block(is_cat, False)

        gh = build_gh3(grad * mask, hess * mask, mask)  # (3, N) f32
        root = root_sums(gh, self.ax)
        hist0 = self.hist_rows(bins_fm, gh)
        root_out = leaf_output(root[0], root[1], params)
        big = torch.full((1,), BIG, dtype=torch.float32, device=dev)
        self.group_mat = group_mat
        fm0, rb0, pen0 = feat_mask, None, None
        if spec.per_node:
            F = num_bins.shape[0]
            self.node_candidates = make_node_candidates(
                spec, params, feat_mask, num_bins, nan_bin, rng_key,
                group_mat, cegb)
            self.leaf_groups = torch.ones((L + 1, max(1, spec.n_groups)),
                                          dtype=torch.bool, device=dev)
            self.path_used = torch.zeros((L + 1, F), dtype=torch.bool,
                                         device=dev)
            self.feat_used = (cegb.used.clone() if spec.cegb else
                              torch.zeros(F, dtype=torch.bool, device=dev))
            fm0, rb0, pen0 = self.node_candidates(
                torch.zeros(1, dtype=torch.int64, device=dev),
                self.leaf_groups[:1], self.path_used[:1], root[2:3],
                self.feat_used)
        rec0 = self.search(
            self.exp_hist(hist0[None], root[0:1], root[1:2], root[2:3]),
            root[0:1], root[1:2], root[2:3], fm0, root_out[None],
            -big if self.has_mono else None,
            big if self.has_mono else None, pen0, rb0)

        self.pbins = bins_fm.clone()  # leaf-grouped along the row axis
        self.pgh = gh
        self.pperm = torch.arange(N, dtype=torch.int64, device=dev)
        self.valid_f = (torch.ones(N, dtype=torch.float32, device=dev)
                        if valid is None else valid)
        self.seg_begin = torch.full((L + 1,), N, dtype=torch.int64,
                                    device=dev)
        self.seg_begin[:1].fill_(0)
        self.seg_count = torch.zeros(L + 1, dtype=torch.int64, device=dev)
        self.seg_count[0] = (self.valid_f > 0).sum()
        self.n_left = torch.zeros(1, dtype=torch.int64, device=dev)
        self.hist = torch.zeros((L + 1, 3, self.Gh, self.Bc),
                                dtype=torch.float32, device=dev)
        self.hist[0] = hist0
        if self.voting:
            # hist_valid[leaf, f]: the stored column holds global sums
            self.hist_valid = torch.ones((L + 1, num_bins.shape[0]),
                                         dtype=torch.bool, device=dev)
        zf = lambda: torch.zeros(L + 1, dtype=torch.float32, device=dev)
        zi = lambda: torch.zeros(L + 1, dtype=torch.int32, device=dev)
        self.best = SplitRecord(
            gain=torch.full((L + 1,), NEG_INF, dtype=torch.float32,
                            device=dev),
            feature=zi(), bin=zi(),
            default_left=torch.zeros(L + 1, dtype=torch.bool, device=dev),
            is_cat=(torch.zeros(L + 1, dtype=torch.bool, device=dev)
                    if spec.has_cat else None),
            cat_mask=(torch.zeros((L + 1, B), dtype=torch.bool, device=dev)
                      if spec.has_cat else None),
            left_g=zf(), left_h=zf(), left_c=zf(),
            right_g=zf(), right_h=zf(), right_c=zf(),
        )
        map_record(lambda b, r: b[:1].copy_(r[:1]), self.best, rec0)
        self.leaf_g, self.leaf_h, self.leaf_c = zf(), zf(), zf()
        self.leaf_g[0], self.leaf_h[0], self.leaf_c[0] = root
        self.leaf_min = torch.full((L + 1,), -BIG, dtype=torch.float32,
                                   device=dev)
        self.leaf_max = torch.full((L + 1,), BIG, dtype=torch.float32,
                                   device=dev)
        self.leaf_parent = torch.full((L + 1,), -1, dtype=torch.int64,
                                      device=dev)
        if spec.mono_mode:
            # ancestry: anc_in[x, a] node a is above leaf x, anc_left[x, a]
            # on its left side
            self.anc_in = torch.zeros((L + 1, L - 1), dtype=torch.bool,
                                      device=dev)
            self.anc_left = torch.zeros_like(self.anc_in)
            self.iota_n = torch.arange(L - 1, device=dev)
        self.t = empty_tree(L + 1, B, dev)
        self.t.leaf_value[0] = root_out
        self.t.leaf_weight[0] = root[1]
        self.t.leaf_count[0] = root[2]
        self.i = torch.zeros((), dtype=torch.int64, device=dev)  # splits
        self.n_rounds = torch.zeros((), dtype=torch.int32, device=dev)

    def exp_hist(self, h, g_, h_, c_):
        """Bundle-space histograms -> per-feature for the split search."""
        if self.spec.efb:
            return expand_hist(h, g_, h_, c_, self.bundle)
        return h

    # ------------------------------------------------------ mesh helpers
    def hist_rows(self, bins, gh) -> torch.Tensor:
        """The histogram of all N rows: reduced over a data axis at the
        scale of every rank's rows; the own column block on a feature
        axis."""
        if self.ax is not None:
            absmax = fx_axis_absmax(gh, self.ax)
            acc = histogram(bins, gh, self.Bc,
                            fx=(absmax, self.axis_rows))
            return fx_axis_reduce(acc, absmax, self.axis_rows, self.ax)
        if self.fax is not None:
            return self.pad_block(histogram(self.block(bins), gh, self.Bc))
        return histogram(bins, gh, self.Bc)

    def block(self, bins) -> torch.Tensor:
        """The own column block of a (G, N) bin matrix (a contiguous
        view: it slices the leading axis)."""
        lo, hi, _ = self.blk
        return bins[lo:hi]

    def pad_block(self, h) -> torch.Tensor:
        """(..., hi - lo, Bc) -> (..., Fb, Bc): zero columns past G."""
        lo, hi, Fb = self.blk
        if hi - lo == Fb:
            return h
        pad = torch.zeros(h.shape[:-2] + (Fb - (hi - lo), h.shape[-1]),
                          dtype=h.dtype, device=h.device)
        return torch.cat([h, pad], dim=-2)

    def global_counts(self, a, b):
        """Row counts summed over a data axis (global left / right sizes:
        every rank must choose the same smaller child)."""
        if self.ax is None:
            return a, b
        g = self.ax.all_reduce(torch.stack([a, b]))
        return g[0], g[1]

    def search(self, hist, sg, sh, sc, fm, po, cmn, cmx, pen=None, rb=None
               ) -> SplitRecord:
        """best_split of a batch of leaves; on a feature axis over the own
        column block, then the global winner (select_global_rec)."""
        if self.fax is None:
            return best_split(
                hist, sg, sh, sc, self.num_bins, self.nan_bin, self.mono,
                self.params, fm, parent_output=po, cmin=cmn, cmax=cmx,
                has_mono=self.has_mono, is_cat=self.is_cat,
                cat_subset=self.spec.cat_subset, penalty=pen, rand_bin=rb)
        rec = best_split(
            hist, sg, sh, sc, self.nb_t, self.nan_t, self.mono_t,
            self.params, self.fm_t, parent_output=po, cmin=cmn, cmax=cmx,
            has_mono=self.has_mono, is_cat=self.iscat_t,
            cat_subset=self.spec.cat_subset)
        return select_global_rec(rec, self.fax, self.blk[0])

    def link(self, leaves, node_ids, new_ids, act) -> None:
        """Tree::Split on the links, batched: node node_ids[r] takes leaf
        leaves[r]'s place under its parent, with children ~leaves[r] and
        ~new_ids[r]; act marks the live entries."""
        t, L = self.t, self.L
        dump = torch.full_like(node_ids, L - 1)
        p = self.leaf_parent[leaves]
        has_p = (p >= 0) & act
        pc = p.clamp_min(0)
        p_is_left = t.node_left[pc] == ~leaves.to(torch.int32)
        nid32 = node_ids.to(torch.int32)
        _put(t.node_left, torch.where(has_p & p_is_left, pc, dump), nid32)
        _put(t.node_right, torch.where(has_p & ~p_is_left, pc, dump), nid32)
        _put(t.node_left, node_ids, ~leaves.to(torch.int32))
        _put(t.node_right, node_ids, ~new_ids.to(torch.int32))

    def children_best(self, left_h, right_h, rec: SplitRecord, lo, ro,
                      cmn, cmx, depth, extras=(None, None, None),
                      valid=None) -> SplitRecord:
        """Best splits of the left children then the right children, in
        one batched search; a child at max_depth gets gain NEG_INF.
        extras: the children's (feat_mask, rand_bin, penalty) under the
        per-node extras; valid: voting's (2 n, F) columns that hold
        global sums."""
        ch_g = torch.cat([rec.left_g, rec.right_g])
        ch_h = torch.cat([rec.left_h, rec.right_h])
        ch_c = torch.cat([rec.left_c, rec.right_c])
        fm, rb, pen = extras
        fm = self.feat_mask if fm is None else fm
        if valid is not None:  # voting: only columns holding global sums
            fm = (fm if fm.dim() == 2 else fm[None]) & valid
        ch = self.search(
            self.exp_hist(torch.cat([left_h, right_h]), ch_g, ch_h, ch_c),
            ch_g, ch_h, ch_c, fm, torch.cat([lo, ro]), cmn, cmx, pen, rb)
        md = self.spec.max_depth
        if md <= 0:
            return ch
        ok = depth < md
        return ch._replace(gain=torch.where(
            torch.cat([ok, ok]), ch.gain, torch.full_like(ch.gain, NEG_INF)))

    def outputs(self, rec: SplitRecord, leaves):
        """Child outputs and monotone intervals of splits of `leaves`."""
        pmin, pmax = self.leaf_min[leaves], self.leaf_max[leaves]
        lo, ro = split_leaf_outputs(
            rec, self.params, self.t.leaf_value[leaves],
            pmin if self.has_mono else None, pmax if self.has_mono else None,
            self.num_bins, self.spec.cat_subset)
        if self.has_mono and not self.spec.mono_mode:
            lmin, lmax, rmin, rmax = monotone_child_intervals(
                rec.feature, rec.is_cat, self.mono, lo, ro, pmin, pmax)
            return lo, ro, (lmin, lmax, rmin, rmax)
        return lo, ro, None

    def record(self, leaves, news, node_ids, rec, lo, ro, iv, ch, depth):
        """Write the splits of `leaves` (children `leaves` and `news`, at
        nodes `node_ids`, index tensors) into the tree, the leaf tables
        and the best-split records."""
        t = self.t
        _put(t.node_feature, node_ids, rec.feature)
        _put(t.node_bin, node_ids, rec.bin)
        _put(t.node_gain, node_ids, rec.gain)
        _put(t.node_default_left, node_ids, rec.default_left)
        if self.is_cat is not None:
            _put(t.node_cat, node_ids, rec.is_cat)
            _put(t.node_cat_mask, node_ids, rec.cat_mask)
        _put(t.node_value, node_ids, t.leaf_value[leaves])
        _put(t.node_weight, node_ids, self.leaf_h[leaves])
        _put(t.node_count, node_ids, self.leaf_c[leaves])
        pairs = [(t.leaf_value, lo, ro), (t.leaf_weight, rec.left_h,
                                          rec.right_h),
                 (t.leaf_count, rec.left_c, rec.right_c),
                 (t.leaf_depth, depth, depth),
                 (self.leaf_g, rec.left_g, rec.right_g),
                 (self.leaf_h, rec.left_h, rec.right_h),
                 (self.leaf_c, rec.left_c, rec.right_c),
                 (self.leaf_parent, node_ids, node_ids)]
        if iv is not None:
            lmin, lmax, rmin, rmax = iv
            pairs += [(self.leaf_min, lmin, rmin),
                      (self.leaf_max, lmax, rmax)]
        for arr, left, right in pairs:
            _put(arr, leaves, left)
            _put(arr, news, right)
        if ch is None:  # monotone intermediate: searched again after
            return
        ch_leaf = torch.cat([leaves, news])
        map_record(lambda b, v: _put(b, ch_leaf, v), self.best, ch)

    # ------------------------------------------------------------ round
    def round_cond(self) -> torch.Tensor:
        """_round_cond: some gain is positive and splitting every such
        leaf stays within the leaf budget."""
        n = (self.best.gain[:self.L] > 0.0).sum()
        return (n > 0) & (self.i + 1 + n <= self.L)

    def one_round(self, pleaf: torch.Tensor) -> None:
        """_round_body over S = L // 2 + 1 slots: slot r takes the r-th
        positive-gain leaf in leaf order (node i + r, new leaf i + 1 + r);
        a round whose predicate is false splits nothing."""
        L, N, dev = self.L, self.N, self.dev
        S = L // 2 + 1
        best = self.best
        go = self.round_cond()
        pos_gain = (best.gain[:L] > 0.0) & go
        n_split = pos_gain.sum()
        order = torch.argsort((~pos_gain).to(torch.int32), stable=True)[:S]
        slot = torch.arange(S, device=dev)
        act = slot < n_split
        i = self.i
        tl = torch.where(act, order, L)
        node_ids = torch.where(act, i + slot, L - 1)
        new_ids = torch.where(act, i + 1 + slot, L)
        rec = map_record(lambda f: f[tl], best)
        lo, ro, iv = self.outputs(rec, tl)
        self.link(tl, node_ids, new_ids, act)
        depth = self.t.leaf_depth[tl] + 1

        # ---- per-row decision for all split leaves at once
        mask = torch.cat([pos_gain, torch.zeros(1, dtype=torch.bool,
                                                device=dev)])  # (L + 1,)
        pl_c = pleaf.clamp_max(L - 1).long()
        f_row = best.feature[pl_c].long()
        col = self.bundle.bundle_of[f_row].long() if self.spec.efb \
            else f_row
        fb = self.pbins.gather(0, col[None, :])[0]
        if self.spec.efb:
            fb = decode_feature_bins(fb, f_row, self.bundle)
        fnan = self.nan_bin[f_row]
        go_left = (fb <= best.bin[pl_c]) | (
            best.default_left[pl_c] & (fb == fnan) & (fnan >= 0))
        if self.is_cat is not None:
            B = best.cat_mask.shape[1]
            cat_hit = best.cat_mask.reshape(-1)[
                pl_c * B + fb.clamp(0, B - 1).long()]
            go_left = torch.where(best.is_cat[pl_c], cat_hit, go_left)
        in_split = mask[pl_c] & (pleaf < L)
        new_of = torch.full((L + 1,), L, dtype=torch.int32, device=dev)
        _put(new_of, tl, new_ids.to(torch.int32))
        pleaf_new = torch.where(in_split & ~go_left, new_of[pl_c], pleaf)

        # ---- stable multi-leaf partition: destination = segment
        # start + rank among the row's child, by two prefix sums
        gl_in = in_split & go_left
        gr_in = in_split & ~go_left
        P_l = _excl_prefix(gl_in)
        P_r = _excl_prefix(gr_in)
        beg = self.seg_begin[:L]
        endp = torch.clamp_max(beg + self.seg_count[:L], N)
        n_l = P_l[endp] - P_l[beg.clamp_max(N)]
        n_l = torch.cat([torch.where(pos_gain, n_l, 0), n_l.new_zeros(1)])
        beg = self.seg_begin
        pos = torch.arange(N, dtype=torch.int64, device=dev)
        b_row = beg[pl_c].clamp_max(N)
        dst_l = b_row + (P_l[:-1] - P_l[b_row])
        dst_r = b_row + n_l[pl_c] + (P_r[:-1] - P_r[b_row])
        dst = torch.where(gl_in, dst_l, torch.where(gr_in, dst_r, pos))
        inv = torch.empty_like(pos).scatter_(0, dst, pos)
        self.pbins.copy_(self.pbins.index_select(1, inv))
        self.pgh.copy_(self.pgh.index_select(1, inv))
        self.pperm.copy_(self.pperm[inv])
        pleaf.copy_(pleaf_new[inv])
        n_r = torch.where(mask, self.seg_count - n_l, 0)
        gn_l, gn_r = self.global_counts(n_l, n_r)
        left_smaller = gn_l <= gn_r  # (L + 1,) on the global counts
        sm_begin = torch.where(left_smaller, beg, beg + n_l)[tl]
        sm_count = torch.where(left_smaller, n_l, n_r)[tl]
        seg_new = (beg + n_l)[tl]
        n_r_t, n_l_t = n_r[tl], n_l[tl]
        _put(self.seg_begin, new_ids, seg_new)
        _put(self.seg_count, new_ids, n_r_t)
        _put(self.seg_count, tl, n_l_t)

        # ---- all smaller children in one pass, larger by subtraction
        slot_begin = torch.where(act, sm_begin, 0).to(torch.int32)
        slot_count = torch.where(act, sm_count, 0).to(torch.int32)
        if self.ax is not None:
            absmax = fx_axis_absmax(self.pgh, self.ax)
            small = fx_axis_reduce(
                hist_slots(self.pbins, self.pgh, slot_begin, slot_count,
                           self.Bc, S, fx=(absmax, self.axis_rows)),
                absmax, self.axis_rows, self.ax)
        elif self.fax is not None:
            small = self.pad_block(hist_slots(
                self.block(self.pbins), self.pgh, slot_begin, slot_count,
                self.Bc, S))
        else:
            small = hist_slots(self.pbins, self.pgh, slot_begin, slot_count,
                               self.Bc, S)
        large = self.hist[tl] - small
        ls = left_smaller[tl][:, None, None, None]
        left_h = torch.where(ls, small, large)
        right_h = torch.where(ls, large, small)
        _put(self.hist, tl, left_h)
        _put(self.hist, new_ids, right_h)

        if iv is not None:
            cmn, cmx = torch.cat([iv[0], iv[2]]), torch.cat([iv[1], iv[3]])
        else:
            cmn = cmx = None
        ch = self.children_best(left_h, right_h, rec, lo, ro, cmn, cmx,
                                depth)
        self.record(tl, new_ids, node_ids, rec, lo, ro, iv, ch, depth)
        self.i.add_(n_split)
        self.n_rounds.add_((n_split > 0).to(torch.int32))

    # ------------------------------------------------------- sequential
    def forced_step(self):
        """Plan entry min(i, n - 1) on its leaf's histogram: (leaf (1,),
        feature, bin, whether it applies now with both children
        non-empty, the left and parent (g, h, count) sums)."""
        forced, n_forced = self.forced, self.spec.n_forced
        fi = torch.clamp_max(self.i, n_forced - 1).reshape(1)
        fl, ff, fb = (a.index_select(0, fi).long()
                      for a in (forced.leaf, forced.feature, forced.bin))
        pg, ph, pc = (a.index_select(0, fl)
                      for a in (self.leaf_g, self.leaf_h, self.leaf_c))
        fh = self.exp_hist(self.hist.index_select(0, fl), pg, ph, pc)[0]
        left = cumsum_last(fh.index_select(1, ff)[:, 0])  # (3, B)
        flg, flh, flc = left.index_select(1, fb)[:, 0]
        use = (self.i < n_forced) & (flc > 0) & (pc[0] - flc > 0)
        return fl, ff[0], fb[0], use, (flg, flh, flc, pg[0], ph[0], pc[0])

    def growing(self) -> torch.Tensor:
        """cond: a split is left in the budget and some gain is positive
        or a forced entry can split."""
        keep = self.best.gain[:self.L].max() > 0.0
        if self.spec.n_forced:
            keep = keep | self.forced_step()[3]
        return (self.i < self.L - 1) & keep

    def split_one(self, loop: DeviceLoop) -> None:
        """body: split the best leaf (or the forced entry's) at node i,
        its right child leaf i + 1; a no-op (dump rows only) once
        growing() is false."""
        L, dev = self.L, self.dev
        go = self.growing()
        am = first_argmax(self.best.gain[:L]).reshape(1)
        use = None
        if self.spec.n_forced:
            fl, ff, fb, use, sums = self.forced_step()
            am = torch.where(use, fl, am)
        i1 = self.i.reshape(1)
        l = torch.where(go, am, L)
        node = torch.where(go, i1, L - 1)
        new = torch.where(go, i1 + 1, L)
        rec = map_record(lambda f: f[l], self.best)
        if use is not None:
            rec = forced_record(rec, use.reshape(1), ff, fb, sums,
                                self.params)
        lo, ro, iv = self.outputs(rec, l)
        self.link(l, node, new, go.reshape(1))
        depth = self.t.leaf_depth[l] + 1

        # ---- stable partition of [b, b + c) in a window of the ladder
        b, c = self.seg_begin[l], self.seg_count[l]  # (1,) each
        feat = rec.feature.long()  # (1,)
        col = self.bundle.bundle_of[feat].long() if self.spec.efb else feat
        loop.ladder(c, self.caps,
                    lambda cap: self.partition(cap, b, c, feat, col, rec))
        n_l = self.n_left
        n_r = c - n_l
        gn_l, gn_r = self.global_counts(n_l, n_r)
        left_smaller = gn_l <= gn_r  # on the global counts
        _put(self.seg_begin, new, b + n_l)
        _put(self.seg_count, l, n_l)
        _put(self.seg_count, new, n_r)

        # ---- smaller child over its segment, larger by subtraction
        small, el = self.small_hist(
            torch.where(left_smaller, b, b + n_l),
            torch.where(left_smaller, n_l, n_r))
        large = self.hist[l][0] - small
        left_h = torch.where(left_smaller, small, large)
        right_h = torch.where(left_smaller, large, small)
        _put(self.hist, l, left_h[None])
        _put(self.hist, new, right_h[None])

        if iv is not None:
            cmn, cmx = torch.cat([iv[0], iv[2]]), torch.cat([iv[1], iv[3]])
        else:
            cmn = cmx = None
        extras = (None, None, None)
        if self.spec.per_node:
            # the two children's candidates: groups still legal and path
            # features from the parent plus its split feature
            F = self.path_used.shape[1]
            f_oh = torch.arange(F, device=dev)[None, :] == feat[:, None]
            grp = self.leaf_groups[l]
            if self.spec.n_groups:
                grp = grp & self.group_mat[:, feat].T
            pu = self.path_used[l] | f_oh
            self.feat_used.logical_or_(f_oh[0] & go)
            extras = self.node_candidates(
                torch.cat([2 * i1 + 1, 2 * i1 + 2]),
                torch.cat([grp, grp]), torch.cat([pu, pu]),
                torch.cat([rec.left_c, rec.right_c]), self.feat_used)
            for arr, v in ((self.leaf_groups, grp), (self.path_used, pu)):
                _put(arr, l, v)
                _put(arr, new, v)
        valid = None
        if el is not None:
            # the smaller child is global at the elected columns, the
            # larger one where the parent's column was too
            v_par = self.hist_valid[l][0]
            v_left = torch.where(left_smaller, el, el & v_par)
            v_right = torch.where(left_smaller, el & v_par, el)
            _put(self.hist_valid, l, v_left[None])
            _put(self.hist_valid, new, v_right[None])
            valid = torch.stack([v_left, v_right])
        ch = None
        if not self.spec.mono_mode:
            ch = self.children_best(left_h[None], right_h[None], rec, lo, ro,
                                    cmn, cmx, depth, extras, valid)
        self.record(l, new, node, rec, lo, ro, iv, ch, depth)
        self.i.add_(go.to(torch.int64))
        if self.spec.mono_mode:
            self.mono_split(l, node, new, go)

    def small_hist(self, begin, count):
        """The smaller child's (3, Gh, Bc) histogram over its segment and,
        under voting, the (F,) elected columns (else None). On a data
        axis: int64 partials at the scale of the segment's maxima over
        every rank and n = axis_rows // 2 (one device's hist_cap); voting
        elects from each rank's local f32 sums and reduces only the
        elected columns (permuted.py:719-791)."""
        if self.fax is not None:
            return self.pad_block(histogram(
                self.block(self.pbins), self.pgh, self.Bc, begin=begin,
                count=count, cap=self.hist_cap)), None
        if self.ax is None:
            return histogram(self.pbins, self.pgh, self.Bc, begin=begin,
                             count=count, cap=self.hist_cap), None
        pos = torch.arange(self.N, device=self.dev)
        inside = (pos >= begin) & (pos < begin + count)
        n_sc = max(self.axis_rows // 2, 1)
        absmax = fx_axis_absmax(self.pgh, self.ax, inside)
        # a rank's share of the globally smaller child may exceed half
        # its rows: the launch is bounded by all of them
        acc = histogram(self.pbins, self.pgh, self.Bc, begin=begin,
                        count=count, cap=self.N, fx=(absmax, n_sc))
        if not self.voting:
            return fx_axis_reduce(acc, absmax, n_sc, self.ax), None
        G = acc.shape[1]
        local = fx_to_f32(acc, fx_exponents(absmax, n_sc))
        lsum = local[:, 0, :].sum(dim=-1)  # (3,) this rank's totals
        lg = feature_best_gains(
            self.exp_hist(local[None], lsum[0:1], lsum[1:2], lsum[2:3]),
            lsum[0:1], lsum[1:2], lsum[2:3], self.num_bins, self.nan_bin,
            self.mono, self.params, self.feat_mask, is_cat=self.is_cat,
            cat_subset=self.spec.cat_subset)[0]  # (F,)
        if self.spec.efb:
            col_gain = torch.full((G,), NEG_INF, dtype=torch.float32,
                                  device=self.dev).scatter_reduce(
                0, self.bundle.bundle_of.long(), lg, "amax")
        else:
            col_gain = lg
        kG = min(self.spec.voting_k, G)
        k2 = min(2 * self.spec.voting_k, G)
        topi = torch.sort(col_gain, descending=True, stable=True).indices[:kG]
        in_topk = torch.zeros(G, dtype=torch.bool, device=self.dev)
        in_topk[topi] = True
        votes = self.ax.all_reduce(in_topk.to(torch.float32))
        score = self.ax.all_reduce(torch.where(
            in_topk, torch.clamp_min(col_gain, 0.0),
            torch.zeros_like(col_gain)))
        eidx = torch.sort(votes * 1e12 + score, descending=True,
                          stable=True).indices[:k2]
        comp = fx_axis_reduce(acc[:, eidx, :], absmax, n_sc, self.ax)
        small = torch.zeros_like(local)
        small[:, eidx, :] = comp
        elected = torch.zeros(G, dtype=torch.bool, device=self.dev)
        elected[eidx] = True
        if self.spec.efb:
            elected = elected[self.bundle.bundle_of.long()]
        return small, elected

    def partition(self, cap: int, b, c, feat, col, rec: SplitRecord
                  ) -> None:
        """mk_part at capacity cap: the window [start, start + cap) at
        the device begin b holds the segment [b, b + c); its rows go
        left, then right, each in their order, and the rows outside the
        segment stay. Writes the left count into n_left."""
        N, dev = self.N, self.dev
        start = b.clamp(0, N - cap)
        off = b - start
        iota = torch.arange(cap, dtype=torch.int64, device=dev)
        idx = start + iota
        sbins = self.pbins.index_select(1, idx)  # (G, cap)
        sgh = self.pgh.index_select(1, idx)
        sperm = self.pperm.index_select(0, idx)
        fb = sbins.index_select(0, col)[0]
        if self.spec.efb:
            fb = decode_feature_bins(fb, feat, self.bundle)
        fnan = self.nan_bin[feat]
        gl = (fb <= rec.bin) | (rec.default_left & (fb == fnan) & (fnan >= 0))
        if self.is_cat is not None:
            B = rec.cat_mask.shape[1]
            gl = torch.where(rec.is_cat,
                             rec.cat_mask[0, fb.clamp(0, B - 1).long()], gl)
        in_seg = (iota >= off) & (iota < off + c)
        sel_l = in_seg & gl
        sel_r = in_seg & ~gl
        li = sel_l.to(torch.int64)
        ri = sel_r.to(torch.int64)
        lrank = torch.cumsum(li, dim=0) - li
        rrank = torch.cumsum(ri, dim=0) - ri
        n_l = li.sum().reshape(1)
        dst = torch.where(sel_l, off + lrank,
                          torch.where(sel_r, off + n_l + rrank, iota))
        didx = start + dst
        self.pbins.index_copy_(1, didx, sbins)
        self.pgh.index_copy_(1, didx, sgh)
        self.pperm.index_copy_(0, didx, sperm)
        self.n_left.copy_(n_l)

    def mono_split(self, l, node, new, go) -> None:
        """After split `node` of leaf l (children l and new), monotone
        intermediate (permuted.py:866-918): the ancestry takes the split,
        every leaf's bounds are computed again (grower.mono_bounds), and
        every live leaf's best split is searched again under them."""
        L, dev = self.L, self.dev
        oh = ((self.iota_n[None, :] == node[:, None])
              & go.reshape(1, 1))  # (1, L - 1)
        row_in, row_lf = self.anc_in[l], self.anc_left[l]
        _put(self.anc_in, l, row_in | oh)
        _put(self.anc_left, l, row_lf | oh)
        _put(self.anc_in, new, row_in | oh)
        _put(self.anc_left, new, row_lf)
        t = self.t
        nmin, nmax = mono_bounds(1, self.anc_in[:L], self.anc_left[:L],
                                 t.leaf_value[:L], t.node_feature[:L - 1],
                                 t.node_cat[:L - 1], self.mono, self.i)
        lg, lh, lc = self.leaf_g[:L], self.leaf_h[:L], self.leaf_c[:L]
        rec = best_split(
            self.exp_hist(self.hist[:L], lg, lh, lc), lg, lh, lc,
            self.num_bins, self.nan_bin, self.mono, self.params,
            self.feat_mask, parent_output=t.leaf_value[:L], cmin=nmin,
            cmax=nmax, has_mono=True, is_cat=self.is_cat,
            cat_subset=self.spec.cat_subset)
        live = torch.arange(L, device=dev) <= self.i
        if self.spec.max_depth > 0:
            live = live & (t.leaf_depth[:L] < self.spec.max_depth)
        rec = rec._replace(gain=torch.where(
            live, rec.gain, torch.full_like(rec.gain, NEG_INF)))
        map_record(lambda b, v: b[:L].copy_(v), self.best, rec)
        self.leaf_min[:L].copy_(nmin)
        self.leaf_max[:L].copy_(nmax)

    # ----------------------------------------------------------- result
    def finish(self, valid) -> Tuple[TreeArrays, torch.Tensor]:
        """Tree arrays and the natural-order row -> leaf (permuted.py
        :952-968): position p belongs to the last leaf whose segment
        begins at or before p; empty and unused leaves sort last."""
        L, N, dev = self.L, self.N, self.dev
        cnt, beg = self.seg_count[:L], self.seg_begin[:L]
        eff = torch.where(cnt > 0, beg, N)
        order = torch.argsort(eff, stable=True)
        pos = torch.arange(N, dtype=torch.int64, device=dev)
        j = torch.searchsorted(eff[order].contiguous(), pos, right=True) - 1
        leaf_of_pos = order[j.clamp(0, L - 1)].to(torch.int32)
        row_leaf = torch.empty(N, dtype=torch.int32, device=dev)
        row_leaf.index_put_((self.pperm,), leaf_of_pos)
        if valid is not None:
            row_leaf = torch.where(valid > 0, row_leaf,
                                   torch.full_like(row_leaf, -1))
        t = self.t
        t = TreeArrays(
            num_nodes=self.i.to(torch.int32),
            **{f: getattr(t, f)[:L - 1] for f in TreeArrays._fields
               if f.startswith("node_")},
            **{f: getattr(t, f)[:L] for f in TreeArrays._fields
               if f.startswith("leaf_")},
        )
        return t, row_leaf


def grow_tree_permuted(
    bins_fm: torch.Tensor,  # (G, N) int32
    nan_bin: torch.Tensor,  # (F,) int32
    num_bins: torch.Tensor,  # (F,) int32
    mono: torch.Tensor,  # (F,) int32
    is_cat: torch.Tensor,  # (F,) bool
    grad: torch.Tensor,  # (N,) f32
    hess: torch.Tensor,  # (N,) f32
    mask: torch.Tensor,  # (N,) f32 validity * bagging
    feat_mask: torch.Tensor,  # (F,) bool
    params: SplitParams,
    spec: GrowerSpec,
    valid: Optional[torch.Tensor] = None,
    bundle: Optional[BundleInfo] = None,
    rng_key: Optional[torch.Tensor] = None,
    group_mat: Optional[torch.Tensor] = None,
    cegb: Optional[CegbInfo] = None,
    forced: Optional[ForcedSplits] = None,
    loop: Optional[DeviceLoop] = None,
) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree -> (tree arrays, natural-order row -> leaf, -1 on
    rows with valid == 0). rng_key, group_mat, cegb and forced: the
    per-node extras and forced plan of grower.grow_tree. loop: how the
    loops run (device_loop; EAGER when None); the tree's (rounds of its
    round phase, still splitting at the bounded round cap) are appended
    to loop.trees as device tensors."""
    if spec.rounds and (spec.per_node or spec.n_forced):
        raise ValueError("tpu_growth_rounds excludes per-node extras")
    if spec.mono_mode and (spec.per_node or spec.n_forced or spec.rounds):
        # permuted.py:214-220: the re-search takes the plain feature mask
        raise ValueError(
            "monotone intermediate/advanced excludes per-node extras / "
            "forced splits / rounds")
    if spec.mono_mode == 2:
        raise ValueError("monotone advanced rides the rounds grower only "
                         "(boosting runs intermediate on the exact grower)")
    loop = loop or DeviceLoop()
    g = _Grower(bins_fm, nan_bin, num_bins, mono, is_cat, grad, hess, mask,
                feat_mask, params, spec, valid, bundle, rng_key, group_mat,
                cegb, forced)
    L = spec.num_leaves
    overflow = torch.zeros((), dtype=torch.bool, device=g.dev)
    if spec.rounds and L > 2:
        pleaf = torch.where(g.valid_f > 0, 0, L).to(torch.int32)
        if loop.bounded:
            loop.run(round_phase_cap(L), g.round_cond,
                     lambda: g.one_round(pleaf))
            overflow = g.round_cond()
        else:
            for _ in range(L - 1):  # one host read a round
                if not bool(g.round_cond()):
                    break
                g.one_round(pleaf)
    if loop.bounded:
        loop.run(L - 1, g.growing, lambda: g.split_one(loop))
    else:
        for _ in range(L - 1):  # one host read a split, and its size
            if not bool(g.growing()):
                break
            g.split_one(loop)
    loop.trees.append((g.n_rounds, overflow))
    return g.finish(valid)
