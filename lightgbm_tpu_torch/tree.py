"""Tree model: host representation, prediction, and device traversal.

The port of lightgbm_tpu/tree.py: the reference's array-based Tree
(include/LightGBM/tree.h:26, src/io/tree.cpp) with internal node arrays
(split_feature, threshold, decision_type, left/right children with
<0 = ~leaf) and leaf arrays, converted from the grower's TreeArrays, and
the binned device traversal that scores validation sets. decision_type
bits (tree.h:20-21): bit 0 categorical, bit 1 default_left, bits 2-3
missing type (0 None, 1 Zero, 2 NaN).

Numerical decisions are `value <= threshold` -> left; categorical
decisions of loaded models test membership in a bitset.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, List

import numpy as np
import torch

from .binning import K_ZERO_THRESHOLD, MissingType

if TYPE_CHECKING:
    from .dataset import BinnedDataset
    from .learner.grower import TreeArrays

_CAT_MASK = 1
_DEFAULT_LEFT_MASK = 2


def _missing_type_of(dt: int) -> int:
    return (int(dt) >> 2) & 3


@dataclass
class Tree:
    """Host-side decision tree in the reference model-file layout."""

    num_leaves: int
    shrinkage: float = 1.0
    # internal nodes (num_leaves - 1 entries; may be 0 for a stump)
    split_feature: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    split_gain: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    threshold: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    decision_type: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    left_child: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    right_child: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    internal_value: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    internal_weight: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    internal_count: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    # leaves
    leaf_value: np.ndarray = field(default_factory=lambda: np.zeros(1, np.float64))
    leaf_weight: np.ndarray = field(default_factory=lambda: np.zeros(1, np.float64))
    leaf_count: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int64))
    # categorical bitsets (tree.h cat_boundaries_/cat_threshold_)
    num_cat: int = 0
    cat_boundaries: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int64))
    cat_threshold: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint32))
    is_linear: bool = False
    # linear leaves (tree.h leaf_const_/leaf_coeff_/leaf_features_):
    # output = leaf_const + sum(coeff * raw feature), falling back to
    # leaf_value when any leaf feature is NaN (tree.cpp:137-153)
    leaf_const: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    leaf_features: List[List[int]] = field(default_factory=list)
    leaf_coeff: List[List[float]] = field(default_factory=list)

    # ------------------------------------------------------------------
    @staticmethod
    def from_arrays(arrays: "TreeArrays", dataset: "BinnedDataset", shrinkage: float) -> "Tree":
        """Convert device TreeArrays (used-feature indices, bin thresholds)
        to the host model (original feature indices, real thresholds)."""
        n_nodes = int(arrays.num_nodes)
        num_leaves = n_nodes + 1
        t = Tree(num_leaves=num_leaves, shrinkage=shrinkage)
        used = dataset.used_features
        mappers = dataset.mappers

        nf = np.asarray(arrays.node_feature[:n_nodes])
        nb = np.asarray(arrays.node_bin[:n_nodes])
        ndl = np.asarray(arrays.node_default_left[:n_nodes])
        ncat = np.asarray(arrays.node_cat[:n_nodes])
        ncat_mask = np.asarray(arrays.node_cat_mask[:n_nodes]) if ncat.any() else None

        t.split_feature = used[nf].astype(np.int32) if n_nodes else np.zeros(0, np.int32)
        t.split_gain = np.asarray(arrays.node_gain[:n_nodes], dtype=np.float64)
        t.left_child = np.asarray(arrays.node_left[:n_nodes], dtype=np.int32)
        t.right_child = np.asarray(arrays.node_right[:n_nodes], dtype=np.int32)
        t.internal_value = np.asarray(arrays.node_value[:n_nodes], dtype=np.float64)
        t.internal_weight = np.asarray(arrays.node_weight[:n_nodes], dtype=np.float64)
        t.internal_count = np.asarray(
            np.round(arrays.node_count[:n_nodes]), dtype=np.int64
        )
        t.leaf_value = np.asarray(arrays.leaf_value[:num_leaves], dtype=np.float64) * shrinkage
        t.leaf_weight = np.asarray(arrays.leaf_weight[:num_leaves], dtype=np.float64)
        t.leaf_count = np.asarray(np.round(arrays.leaf_count[:num_leaves]), dtype=np.int64)

        thresholds = np.zeros(n_nodes, np.float64)
        decision = np.zeros(n_nodes, np.int32)
        cat_boundaries = [0]
        cat_threshold: List[np.uint32] = []
        n_cat = 0
        for i in range(n_nodes):
            m = mappers[int(t.split_feature[i])]
            dt = 0
            if m.missing_type == MissingType.NAN:
                dt |= 2 << 2
            # NOTE: MissingType.ZERO is intentionally emitted as None: the
            # grower currently routes the zero bin numerically (by
            # threshold), so prediction must too; the reference's
            # zero-as-missing default-direction double scan is a pending
            # milestone (feature_histogram.hpp:832 NA_AS_MISSING path).
            if ncat[i]:
                dt |= _CAT_MASK
                # bitset over the left-going category VALUES (one for
                # one-vs-rest, several for sorted-subset splits —
                # tree.h cat_threshold_ layout)
                bins_left = np.nonzero(ncat_mask[i])[0]
                cat_vals = [
                    int(m.categories[bl])
                    for bl in bins_left
                    if bl < len(m.categories)
                ]
                # empty set degenerates to an all-right bitset (never a
                # valid split; kept loud-safe rather than guessing a bin)
                n_words = (max(cat_vals) // 32 + 1) if cat_vals else 1
                words = [0] * n_words
                for cv in cat_vals:
                    words[cv // 32] |= 1 << (cv % 32)
                thresholds[i] = float(n_cat)  # index into cat_boundaries
                cat_threshold.extend(np.uint32(w) for w in words)
                cat_boundaries.append(len(cat_threshold))
                n_cat += 1
            else:
                if ndl[i]:
                    dt |= _DEFAULT_LEFT_MASK
                thresholds[i] = m.bin_to_value(int(nb[i]))
            decision[i] = dt
        t.threshold = thresholds
        t.decision_type = decision
        t.num_cat = n_cat
        t.cat_boundaries = np.asarray(cat_boundaries, dtype=np.int64)
        t.cat_threshold = np.asarray(cat_threshold, dtype=np.uint32)
        return t

    # ------------------------------------------------------------------
    def _cat_in_bitset(self, node: int, values: np.ndarray) -> np.ndarray:
        ci = int(self.threshold[node])
        lo, hi = self.cat_boundaries[ci], self.cat_boundaries[ci + 1]
        words = self.cat_threshold[lo:hi]
        finite = np.isfinite(values)
        iv = np.where(finite, values, -1.0).astype(np.int64)
        ok = (iv >= 0) & (iv < 32 * len(words)) & finite
        ivc = np.clip(iv, 0, max(0, 32 * len(words) - 1))
        bits = (words[ivc // 32] >> (ivc % 32).astype(np.uint32)) & 1
        return ok & (bits == 1)

    def go_left(self, node: int, x: np.ndarray) -> bool:
        """The decision of one row at one node (tree.h Decision /
        CategoricalDecision), as predict_leaf takes it."""
        v = x[self.split_feature[node]]
        dt = int(self.decision_type[node])
        if dt & _CAT_MASK:
            if np.isnan(v):
                return False
            return bool(self._cat_in_bitset(node, np.asarray([v]))[0])
        missing_type = (dt >> 2) & 3
        default_left = bool(dt & _DEFAULT_LEFT_MASK)
        isna = np.isnan(v)
        if missing_type == 2:  # NaN as missing
            if isna:
                return default_left
        else:
            if isna:
                v = 0.0
            if missing_type == 1 and abs(v) <= K_ZERO_THRESHOLD:
                return default_left
        return bool(v <= self.threshold[node])

    def predict_leaf(self, X: np.ndarray) -> np.ndarray:
        """Vectorized decision walk -> leaf index per row (Tree::Predict)."""
        n = X.shape[0]
        if self.num_leaves <= 1:
            return np.zeros(n, np.int64)
        cur = np.zeros(n, np.int64)  # node ids; leaves become ~leaf
        active = np.ones(n, bool)
        while np.any(active):
            nodes = cur[active]
            feat = self.split_feature[nodes]
            x = X[active, feat]
            dt = self.decision_type[nodes]
            is_cat = (dt & _CAT_MASK) != 0
            go_left = np.zeros(len(nodes), bool)
            # numerical
            num_idx = ~is_cat
            if np.any(num_idx):
                xv = x[num_idx].astype(np.float64)
                nn = nodes[num_idx]
                thr = self.threshold[nn]
                mt = (dt[num_idx] >> 2) & 3
                dl = (dt[num_idx] & _DEFAULT_LEFT_MASK) != 0
                isna = np.isnan(xv)
                # Zero missing: NaN and 0 treated as missing (tree.cpp Decision)
                miss = np.where(mt == 2, isna, np.where(mt == 1, isna | (np.abs(xv) <= K_ZERO_THRESHOLD), np.zeros_like(isna)))
                xv = np.where(isna & (mt != 2), 0.0, xv)
                gl = np.where(miss, dl, xv <= thr)
                go_left[num_idx] = gl
            if np.any(is_cat):
                cn = nodes[is_cat]
                xv = x[is_cat].astype(np.float64)
                gl = np.zeros(len(cn), bool)
                for u in np.unique(cn):
                    mask = cn == u
                    gl[mask] = self._cat_in_bitset(int(u), xv[mask])
                go_left[is_cat] = gl
            nxt = np.where(go_left, self.left_child[nodes], self.right_child[nodes])
            cur[active] = nxt
            active = cur >= 0
        return ~cur  # leaf index

    def predict(self, X: np.ndarray) -> np.ndarray:
        leaf = self.predict_leaf(X)
        if not self.is_linear:
            return self.leaf_value[leaf]
        return self.linear_leaf_outputs(X, leaf)

    def linear_leaf_outputs(self, X: np.ndarray, leaf: np.ndarray) -> np.ndarray:
        """Linear-leaf outputs per row (tree.cpp:137-153 PredictionFun
        with is_linear): const + coeffs . raw features, NaN -> leaf_value."""
        out = self.leaf_value[leaf].astype(np.float64).copy()
        for l in range(self.num_leaves):
            m = leaf == l
            if not np.any(m):
                continue
            feats = self.leaf_features[l] if l < len(self.leaf_features) else []
            const = self.leaf_const[l] if l < len(self.leaf_const) else 0.0
            if not feats:
                out[m] = const
                continue
            Xl = np.asarray(X, np.float64)[np.ix_(m, feats)]
            v = const + Xl @ np.asarray(self.leaf_coeff[l], np.float64)
            nanrow = np.isnan(Xl).any(axis=1)
            out[m] = np.where(nanrow, self.leaf_value[l], v)
        return out

    def fit_linear_leaves(self, row_leaf: np.ndarray, grad: np.ndarray,
                          hess: np.ndarray, raw: np.ndarray,
                          cat_features: set, linear_lambda: float,
                          shrinkage: float,
                          row_mask: "np.ndarray | None" = None) -> None:
        """One ridge model per leaf on the leaf's path features (the JAX
        package's Tree.fit_linear_leaves, tree.py:262-319;
        linear_tree_learner.cpp:255-358 CalculateLinear): over the leaf's
        in-bag rows without a NaN among those features, solve
        coeffs = -(X^T H X + lambda I)^-1 X^T g in float64 (X with a
        constant column, lambda off the constant), scaled by the
        shrinkage. Categorical features stay off the paths; a leaf with
        fewer usable rows than coefficients, a singular system or a
        non-finite solution keeps its plain value as the constant."""
        L = self.num_leaves
        paths: List[List[int]] = [[] for _ in range(L)]

        def walk(node, feats):
            if node < 0:
                paths[~node] = feats
                return
            f = int(self.split_feature[node])
            nf = feats if (f in cat_features or f in feats) else feats + [f]
            walk(int(self.left_child[node]), nf)
            walk(int(self.right_child[node]), nf)

        if L > 1:
            walk(0, [])
        self.is_linear = True
        self.leaf_const = self.leaf_value.astype(np.float64).copy()
        self.leaf_features = [list(p) for p in paths]
        self.leaf_coeff = [[0.0] * len(p) for p in paths]
        raw = np.asarray(raw, np.float64)
        for leaf in range(L):
            feats = paths[leaf]
            k = len(feats)
            sel = row_leaf == leaf
            if row_mask is not None:  # in-bag rows only (bagging / GOSS)
                sel = sel & row_mask
            if k == 0 or not np.any(sel):
                continue
            Xl = raw[np.ix_(sel, feats)]
            ok = ~np.isnan(Xl).any(axis=1)
            if int(ok.sum()) < k + 1:
                continue
            Xa = np.concatenate([Xl[ok], np.ones((int(ok.sum()), 1))],
                                axis=1)
            g = np.asarray(grad, np.float64)[sel][ok]
            h = np.asarray(hess, np.float64)[sel][ok]
            A = (Xa.T * h) @ Xa
            A[np.arange(k), np.arange(k)] += linear_lambda
            b = Xa.T @ g
            try:
                coef = -np.linalg.solve(A, b)
            except np.linalg.LinAlgError:
                continue
            if not np.isfinite(coef).all():
                continue
            self.leaf_coeff[leaf] = [float(c) * shrinkage for c in coef[:k]]
            self.leaf_const[leaf] = float(coef[k]) * shrinkage

    def max_depth(self) -> int:
        """Decisions on the longest root-to-leaf path (0 for a stump)."""
        if self.num_leaves <= 1:
            return 0
        depth = np.zeros(len(self.left_child), np.int32)
        md = 1
        for i in range(len(self.left_child)):
            for c in (self.left_child[i], self.right_child[i]):
                if c >= 0:
                    depth[c] = depth[i] + 1
                    md = max(md, depth[c] + 1)
                else:
                    md = max(md, depth[i] + 1)
        return int(md)

    def feature_importance_split(self, num_features: int) -> np.ndarray:
        imp = np.zeros(num_features)
        for i in range(len(self.split_feature)):
            if self.split_gain[i] > 0:
                imp[self.split_feature[i]] += 1
        return imp

    def feature_importance_gain(self, num_features: int) -> np.ndarray:
        imp = np.zeros(num_features)
        for i in range(len(self.split_feature)):
            if self.split_gain[i] > 0:
                imp[self.split_feature[i]] += self.split_gain[i]
        return imp


def tree_to_arrays(t: Tree, dataset: "BinnedDataset",
                   device="cpu") -> "TreeArrays":
    """Inverse of Tree.from_arrays (the JAX package's tree.tree_to_arrays,
    tree.py:336): a host model tree -> TreeArrays sized to the tree on
    `device`, for the binned traversal that seeds continued training's
    scores. Thresholds map back through the dataset's bin upper bounds:
    exact for a model trained on this binning, within one bin otherwise.
    A split on a feature that is trivial in this dataset sends every row
    the same way, encoded as an always-left / always-right node on
    feature 0. leaf_depth holds each leaf's depth, so the traversal runs
    the tree's depth in passes."""
    from .learner.grower import TreeArrays

    L = t.num_leaves
    n_nodes = L - 1
    m_ = max(n_nodes, 1)
    B = dataset.max_num_bin
    used_of = {int(f): i for i, f in enumerate(dataset.used_features)}
    nf = np.zeros(m_, np.int32)
    nb = np.zeros(m_, np.int32)
    ndl = np.zeros(m_, bool)
    ncat = np.zeros(m_, bool)
    nmask = np.zeros((m_, B), bool)
    for i in range(n_nodes):
        f_orig = int(t.split_feature[i])
        m = dataset.mappers[f_orig]
        dt = int(t.decision_type[i])
        if f_orig not in used_of:
            row = np.zeros(len(dataset.mappers))
            row[f_orig] = m.min_value
            nf[i] = 0
            nb[i] = B + 1 if t.go_left(i, row) else -1
            continue
        nf[i] = used_of[f_orig]
        if dt & _CAT_MASK:
            ncat[i] = True
            ci = int(t.threshold[i])
            lo, hi = int(t.cat_boundaries[ci]), int(t.cat_boundaries[ci + 1])
            words = t.cat_threshold[lo:hi]
            for cv, b in (m._cat_to_bin or {}).items():
                if (cv // 32 < len(words)
                        and (int(words[cv // 32]) >> (cv % 32)) & 1 and b < B):
                    nmask[i, b] = True
        else:
            ndl[i] = bool(dt & _DEFAULT_LEFT_MASK)
            nb[i] = int(np.clip(
                np.searchsorted(m.upper_bounds, t.threshold[i], side="left"),
                0, max(m.num_bin - 1, 0)))
    depth = np.zeros(L, np.int32)
    stack = [(0, 0)] if n_nodes else []
    while stack:
        node, d = stack.pop()
        for child in (int(t.left_child[node]), int(t.right_child[node])):
            if child >= 0:
                stack.append((child, d + 1))
            else:
                depth[~child] = d + 1

    def nodes(a, dtype):
        return np.asarray(a, dtype) if n_nodes else np.zeros(1, dtype)

    arr = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return TreeArrays(
        num_nodes=torch.tensor(n_nodes, dtype=torch.int32, device=device),
        node_feature=arr(nf), node_bin=arr(nb),
        node_gain=arr(nodes(t.split_gain, np.float32)),
        node_default_left=arr(ndl), node_cat=arr(ncat),
        node_cat_mask=arr(nmask),
        node_left=arr(nodes(t.left_child, np.int32)),
        node_right=arr(nodes(t.right_child, np.int32)),
        node_value=arr(nodes(t.internal_value, np.float32)),
        node_weight=arr(nodes(t.internal_weight, np.float32)),
        node_count=arr(nodes(t.internal_count, np.float32)),
        leaf_value=arr(np.asarray(t.leaf_value, np.float32)),
        leaf_weight=arr(np.asarray(t.leaf_weight, np.float32)),
        leaf_count=arr(np.asarray(t.leaf_count, np.float32)),
        leaf_depth=arr(depth),
    )


def traverse_tree_bins(arrays: "TreeArrays", bins_fm: torch.Tensor,
                       nan_bin: torch.Tensor, bundle=None,
                       has_cat: bool = False, loop=None,
                       max_levels: int = 0) -> torch.Tensor:
    """Device traversal of a grown tree over a BINNED matrix -> per-row
    leaf (int32). Depth-stepped: every row at an internal node advances
    one level per pass (the JAX package's while loop, tree.py:414-493,
    whose condition is "a row is still at an internal node"). Per pass,
    the rows' current-node parameters come from one take over a packed
    (8, nodes) table — the take_small kernel on the card — and each row's
    split-feature bin from a gather. A row at a categorical node goes
    left iff its bin is in the node's category set; has_cat=False (an
    all-numerical dataset) skips that test.

    loop: how the passes run (learner/device_loop.py). On the eager loop
    (None) the tree's depth is read once and bounds them; a bounded loop
    runs max_levels passes (at least the depth: min(L - 1, max_depth,
    the rounds a tree may take)), each a no-op once every row is at a
    leaf, and in a CUDA graph each sits in an IF node on that condition."""
    from .learner.bundle import decode_feature_bins
    from .learner.histogram import take_cols

    G, N = bins_fm.shape
    dev = bins_fm.device
    feat = arrays.node_feature.long()
    node_col = feat if bundle is None else bundle.bundle_of[feat].long()
    pack = torch.stack([
        node_col.to(torch.float32),
        arrays.node_feature.to(torch.float32),
        arrays.node_bin.to(torch.float32),
        arrays.node_default_left.to(torch.float32),
        arrays.node_cat.to(torch.float32),
        arrays.node_left.to(torch.float32),
        arrays.node_right.to(torch.float32),
        nan_bin[feat].to(torch.float32),
    ])  # (8, max_nodes)
    n_nodes = arrays.num_nodes
    rows = torch.arange(N, device=dev)
    row_node = torch.zeros(N, dtype=torch.int32, device=dev)

    def at_internal():
        return (row_node >= 0) & (row_node < n_nodes)

    def level():
        k = torch.clamp_min(row_node, 0)
        v = take_cols(pack, k)  # (8, N)
        col = v[0].to(torch.int64)
        fbins = bins_fm[col, rows]
        if bundle is not None:
            fbins = decode_feature_bins(fbins, v[1].to(torch.int64), bundle)
        fnan = v[7].to(torch.int32)
        go_left = (fbins <= v[2].to(torch.int32)) | (
            (v[3] > 0.5) & (fbins == fnan) & (fnan >= 0))
        if has_cat:
            B = arrays.node_cat_mask.shape[1]
            cat_hit = arrays.node_cat_mask.reshape(-1)[
                k.long() * B + fbins.clamp(0, B - 1).long()]
            go_left = torch.where(v[4] > 0.5, cat_hit, go_left)
        child = torch.where(go_left, v[5], v[6]).to(torch.int32)
        row_node.copy_(torch.where(at_internal(), child, row_node))

    if loop is None or not loop.bounded:
        depth = int(arrays.leaf_depth.max())
        if depth <= 0:  # tree arrays without depths: bound by node count
            depth = int(n_nodes)
        for _ in range(depth):
            level()
    else:
        loop.run(max_levels, lambda: at_internal().any(), level)
    return torch.where(row_node < 0, ~row_node, torch.zeros_like(row_node))
