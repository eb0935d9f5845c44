"""Tensorized forest predictor: the trained model as device tables.

The port of lightgbm_tpu/serving/forest.py. The host walker (tree.py)
walks pointer-shaped trees; on the card every (row, tree) lane gets the
same dense program instead. pack_forest_tables lifts the flat per-tree
arrays (feature index, threshold, decision type, children, leaf values,
categorical bitsets, linear-leaf coefficients) into rectangular
(T, max_nodes) / (T, max_leaves) tables, and forest_apply traverses
all rows x all trees in lockstep:

- per level, every lane's node parameters come from ONE gather of the
  packed node table: learner/histogram.take_rows, which is the
  take_rows kernel (csrc/take_small.cu) on the card and take_rows_plain
  on the CPU. The table is node-major, (T * max_nodes, PACK_WIDTH) f32,
  one 64-byte record a node: the 9 fields of the host packer's
  (9, T * max_nodes) pack (the JAX package's layout), then 7 zero
  columns. The pack goes to its device as it is and is laid out there
  (node_records), once a load (device_tables) or a fleet page-in, never
  per call, so the host packs and copies what it did before; every
  reader (the traversal, contrib_apply, the fleet's slots, the CPU)
  reads that one table;
- each lane's split-feature value is a torch.gather of its row;
- the levels are the forest's max depth, unconditional: a level in
  which every lane already sits at a leaf changes nothing, and nothing
  is read back to the host, so a call is one capturable sequence of
  launches (serving/dispatch.py replays it as one CUDA graph a bucket);
- the per-class sum over trees takes the (T,) tree weights that
  implement start_iteration / num_iteration truncation (a buffer, never
  a new capture), in a fixed pairwise order over iterations: a row's
  score is the same bits in whatever batch it rides, and the same on the
  CPU as on the card.

Decisions mirror tree.py Tree.go_left (missing types None / Zero / NaN,
default direction, categorical bitsets, the linear-leaf NaN fallback).
Thresholds are cast f64 -> f32 downward, so a feature value exactly
representable in f32 goes the host walker's way.

pack_contrib_tables + contrib_apply are the device TreeSHAP (host
shap.py is their oracle): per-leaf root-to-leaf paths with host-packed
cover ("zero") fractions, the row-dependent {0, 1} "one" fractions from
the same split decisions the predictor makes, and the reference's
extend / unwind permutation-weight recursion run in lockstep over every
(row, tree, leaf) lane in torch ops (f32). Its last step adds each lane's
value into its feature column in f64 with index_add_, whose order on the
card is not fixed: contributions agree with host TreeSHAP within 1e-5,
not bit for bit across runs.

The fleet's stacked tables (the JAX package's pad_forest_tables and
stacked_forest_apply): a shape family's models padded to the family's
power-of-two dimensions and laid side by side as one forest of S x T
trees (stack_tables), a slot scored by offsetting every table index by
the slot, a 0-dim int32 on the device.

Everything here takes a device: "cuda" (also "gpu" and "tpu", the JAX
package's word) runs on the card and raises when torch sees none;
"cpu" runs the same torch ops there. A row-sharded forest (mesh=, a
parallel.comm.Mesh of several ranks, each holding the whole forest and
the whole request): each rank scores its block of ceil(N / n) rows and
the blocks are all-gathered in row order, so every rank returns every
row's answer (the JAX package's shard_map over the row axis).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..binning import K_ZERO_THRESHOLD as _K_ZERO

# node fields of the packed table (pack_forest_tables), and the floats of
# a node's record: the record take_rows reads (learner/cuda_hist.py
# TAKE_ROWS_RECORD). 16, not 12: a 64-byte record never straddles a
# 128-byte line, and the serving forest's gathers ran 5% faster so on
# the H100 (PERF.md)
PACK_FIELDS = 9
PACK_WIDTH = 16


def serve_device(device) -> torch.device:
    """The torch device a serving call runs on: "cuda" / "gpu" / "tpu" (or
    "cuda:N", a torch.device) is the card and raises when torch sees none;
    "cpu" / "host" is the CPU. Nothing falls back by itself."""
    if isinstance(device, torch.device):
        dev = device
    else:
        name = str(device).lower()
        if name in ("cpu", "host"):
            return torch.device("cpu")
        dev = torch.device("cuda" if name in ("gpu", "tpu") else name)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unknown serving device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} needs a CUDA device and torch sees none; "
            "pass device='cpu' to score on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def pack_forest_tables(models, num_class: int
                       ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Host packing: list of Tree -> rectangular numpy tables + static
    metadata (the JAX package's packer, unchanged)."""
    T = len(models)
    K = max(int(num_class), 1)
    n_nodes = [max(t.num_leaves - 1, 0) for t in models]
    M = max(n_nodes + [1])
    L = max([t.num_leaves for t in models] + [1])
    depth = max([t.max_depth() for t in models] + [1])

    feature = np.zeros((T, M), np.int32)
    threshold = np.zeros((T, M), np.float32)
    miss_type = np.zeros((T, M), np.int32)
    default_left = np.zeros((T, M), bool)
    is_cat = np.zeros((T, M), bool)
    # padding nodes route straight to leaf 0 so a runaway lane terminates
    left = np.full((T, M), -1, np.int32)
    right = np.full((T, M), -1, np.int32)
    leaf_value = np.zeros((T, L), np.float32)
    cat_lo = np.zeros((T, M), np.int32)
    cat_nw = np.zeros((T, M), np.int32)
    catw_parts: List[np.ndarray] = []
    wbase = 0
    any_cat = False
    any_linear = any(t.is_linear for t in models)
    Ck = 1
    if any_linear:
        Ck = max(
            (len(f) for t in models if t.is_linear for f in t.leaf_features),
            default=1,
        ) or 1
    leaf_const = np.zeros((T, L), np.float32)
    leaf_nf = np.zeros((T, L), np.int32)
    leaf_feat = np.zeros((T, L, Ck), np.int32)
    leaf_coeff = np.zeros((T, L, Ck), np.float32)
    init_node = np.zeros(T, np.int32)
    max_feature = -1

    for ti, t in enumerate(models):
        n = n_nodes[ti]
        if n == 0:
            init_node[ti] = -1  # stump: lane starts AT leaf 0 (~0 == -1)
        else:
            feature[ti, :n] = t.split_feature[:n]
            # directed f64->f32 cast: never round a threshold UP across
            # its f64 value, or an exactly-f32 feature value in
            # (thr, f32(thr)] would flip from right to left vs the f64
            # host walker — a whole-leaf divergence, not 1e-5 noise
            thr64 = np.asarray(t.threshold[:n], np.float64)
            t32 = thr64.astype(np.float32)
            up = t32.astype(np.float64) > thr64
            t32[up] = np.nextafter(t32[up], np.float32(-np.inf))
            threshold[ti, :n] = t32
            dt = np.asarray(t.decision_type[:n], np.int64)
            miss_type[ti, :n] = (dt >> 2) & 3
            default_left[ti, :n] = (dt & 2) != 0
            is_cat[ti, :n] = (dt & 1) != 0
            left[ti, :n] = t.left_child[:n]
            right[ti, :n] = t.right_child[:n]
            max_feature = max(max_feature, int(np.max(t.split_feature[:n])))
            cat_k = np.flatnonzero(is_cat[ti, :n])
            if len(cat_k):
                any_cat = True
                cb = np.asarray(t.cat_boundaries, np.int64)
                words = np.asarray(t.cat_threshold, np.uint32)
                catw_parts.append(words)
                ci = np.asarray(t.threshold, np.float64)[cat_k].astype(np.int64)
                cat_lo[ti, cat_k] = wbase + cb[ci]
                cat_nw[ti, cat_k] = cb[ci + 1] - cb[ci]
                wbase += len(words)
        lv = np.asarray(t.leaf_value, np.float32)
        leaf_value[ti, : len(lv)] = lv
        leaf_const[ti, : len(lv)] = lv  # non-linear: lin path == leaf_value
        if t.is_linear:
            lc = np.asarray(t.leaf_const, np.float32)
            leaf_const[ti, : len(lc)] = lc
            for li, feats in enumerate(t.leaf_features):
                k = len(feats)
                leaf_nf[ti, li] = k
                if k:
                    leaf_feat[ti, li, :k] = feats
                    leaf_coeff[ti, li, :k] = np.asarray(
                        t.leaf_coeff[li], np.float32
                    )
                    max_feature = max(max_feature, max(feats))

    catw = (
        np.concatenate(catw_parts).astype(np.uint32)
        if catw_parts else np.zeros(1, np.uint32)
    )
    # per-node packed parameter table for the single gather a level
    # (node_records lays it node-major on the device): every field is
    # exact in f32 (ints < 2^24, thresholds already f32)
    pack = np.stack([
        feature.reshape(-1).astype(np.float32),       # 0
        threshold.reshape(-1),                        # 1
        miss_type.reshape(-1).astype(np.float32),     # 2
        default_left.reshape(-1).astype(np.float32),  # 3
        is_cat.reshape(-1).astype(np.float32),        # 4
        left.reshape(-1).astype(np.float32),          # 5
        right.reshape(-1).astype(np.float32),         # 6
        cat_lo.reshape(-1).astype(np.float32),        # 7
        cat_nw.reshape(-1).astype(np.float32),        # 8
    ])
    class_onehot = np.zeros((T, K), np.float32)
    class_onehot[np.arange(T), np.arange(T) % K] = 1.0

    tables = {
        "pack": pack,                         # (9, T*M) f32
        "catw": catw.view(np.int32),          # (W,) int32 bit-patterns
        "leaf_value": leaf_value,             # (T, L) f32
        "leaf_const": leaf_const,             # (T, L) f32
        "leaf_nf": leaf_nf,                   # (T, L) int32
        "leaf_feat": leaf_feat,               # (T, L, Ck) int32
        "leaf_coeff": leaf_coeff,             # (T, L, Ck) f32
        "init_node": init_node,               # (T,) int32
        "class_onehot": class_onehot,         # (T, K) f32
    }
    meta = {
        "num_trees": T, "num_class": K, "max_nodes": M, "max_leaves": L,
        "max_depth": int(depth), "has_cat": bool(any_cat),
        "linear": bool(any_linear), "max_feature": int(max_feature),
    }
    return tables, meta


def node_records(fields: torch.Tensor) -> torch.Tensor:
    """(PACK_FIELDS, R) packed node fields -> (R, PACK_WIDTH) node records
    on the fields' device: the fields in order, then zero columns (a
    transpose on the device, once a load or page-in)."""
    out = fields.new_zeros((fields.shape[1], PACK_WIDTH))
    out[:, :PACK_FIELDS] = fields.T
    return out


def device_tables(tables: Dict[str, np.ndarray],
                  device) -> Dict[str, torch.Tensor]:
    """Host tables (pack_forest_tables') on `device`: each copied as it
    is, then the pack laid out there as node records."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in tables.items()}
    out["pack"] = node_records(out["pack"])
    return out


def go_left(v: torch.Tensor, x: torch.Tensor, catw: torch.Tensor,
            has_cat: bool, cat_base=0) -> torch.Tensor:
    """Split decision for gathered node params ``v`` (9, *S) against
    gathered feature values ``x`` (*S): Tree.go_left on the device, shared
    by the traversal and the TreeSHAP path evaluation. cat_base: where
    the forest's bitset words start in catw (a stack slot's)."""
    thr = v[1]
    mt = v[2].to(torch.int32)
    dl = v[3] > 0.5
    isna = torch.isnan(x)
    # missing != NaN: NaN behaves as 0.0 (tree.h Decision)
    xv = torch.where(isna & (mt != 2), 0.0, x)
    miss = torch.where(mt == 2, isna, (mt == 1) & (xv.abs() <= _K_ZERO))
    gl = torch.where(miss, dl, xv <= thr)
    if has_cat:
        nw = v[8].to(torch.int32)
        # NaN and infinities are no category; the clamp keeps the int32
        # conversion in range (truncation toward zero, as the host's)
        iv = torch.nan_to_num(x, nan=-1.0, posinf=-1.0, neginf=-1.0)
        iv = iv.clamp(-1.0, 2.0 ** 30).to(torch.int32)
        ok = (~isna) & (iv >= 0) & (iv < 32 * nw)
        ivc = iv.clamp(min=0)
        widx = v[7].to(torch.int32) + cat_base + ivc // 32
        w = catw[widx.clamp(0, catw.shape[0] - 1).long()]
        # bit s of an int32 word: (w >> s) & 1 under the arithmetic shift
        bit = (w >> (ivc % 32)) & 1
        gl = torch.where(v[4] > 0.5, ok & (bit == 1), gl)
    return gl


def class_sums(w: torch.Tensor, K: int) -> torch.Tensor:
    """(N, T) per-tree values, tree t of class t % K -> (N, K) sums over
    the iterations in a fixed pairwise order: each output element is the
    same sum of the same terms whatever N, on the CPU and on the card."""
    N, T = w.shape
    n = T // K
    p = 1 << max(n - 1, 0).bit_length()
    a = w.reshape(N, n, K)
    if p != n:  # zero iterations up to a power of two
        a = torch.cat([a, a.new_zeros((N, p - n, K))], 1)
    while p > 1:
        p //= 2
        a = a[:, :p] + a[:, p:]
    return a[:, 0]


def forest_apply(tables: Dict[str, torch.Tensor], X: torch.Tensor,
                 tree_w: torch.Tensor, *, has_cat: bool = True,
                 linear: bool = False, levels: int = 0, slot=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Traversal: (N, F) f32 rows x all T trees -> per-class raw scores
    (N, K) f32 and per-tree leaf indices (N, T) int32, on the device of
    the tables. `tree_w` is the (T,) f32 per-tree weight implementing
    iteration truncation; `levels` the levels to descend (the forest's
    max depth; <= 0 takes max_nodes, which always suffices). With `slot`
    (a 0-dim int32 on the tables' device), the tables are a family's
    stack (stack_tables) and the forest is slot `slot`'s T = len(tree_w)
    trees: every table index is offset on the device. Reads nothing back
    to the host."""
    from ..learner.histogram import take_rows

    pack = tables["pack"]  # (T_all * M, PACK_WIDTH) node records
    T_all, L = tables["leaf_value"].shape
    T = tree_w.shape[0]
    M = pack.shape[0] // T_all
    K = tables["class_onehot"].shape[1]
    N = X.shape[0]
    dev = X.device
    tree = torch.arange(T, dtype=torch.int32, device=dev)
    cat_base = 0
    init = tables["init_node"]
    if slot is not None:
        tree = tree + slot * T
        cat_base = slot * (tables["catw"].shape[0] // (T_all // T))
        init = init[tree]  # the slot's trees (a forest's own: all of it)
    tpos = (tree * M)[None, :]
    cur = init[None, :].expand(N, T)
    for _ in range(levels if levels > 0 else M):
        node = cur.clamp(min=0)  # leaf lanes compute a dead decision
        flat = (tpos + node).reshape(-1)  # (N*T,) int32
        v = take_rows(pack, flat, PACK_FIELDS).view(PACK_FIELDS, N, T)
        x = torch.gather(X, 1, v[0].long())  # (N, T)
        gl = go_left(v, x, tables["catw"], has_cat, cat_base)
        child = torch.where(gl, v[5], v[6]).to(torch.int32)
        cur = torch.where(cur >= 0, child, cur)
    leaf = torch.where(cur < 0, ~cur, 0)  # (N, T) int32
    lflat = ((tree * L)[None, :] + leaf).reshape(-1)
    val = tables["leaf_value"].reshape(-1)[lflat].view(N, T)
    if linear:
        Ck = tables["leaf_feat"].shape[2]
        const = tables["leaf_const"].reshape(-1)[lflat].view(N, T)
        nf = tables["leaf_nf"].reshape(-1)[lflat].view(N, T)
        fidx = tables["leaf_feat"].reshape(-1, Ck)[lflat]  # (N*T, Ck)
        co = tables["leaf_coeff"].reshape(-1, Ck)[lflat].view(N, T, Ck)
        xg = torch.gather(X, 1, fidx.view(N, T * Ck).long()).view(N, T, Ck)
        contrib = torch.zeros_like(val)
        anynan = torch.zeros_like(val, dtype=torch.bool)
        for j in range(Ck):  # fixed order over the leaf's features
            used = nf > j
            contrib = contrib + torch.where(used, co[..., j] * xg[..., j],
                                            0.0)
            anynan = anynan | (used & torch.isnan(xg[..., j]))
        # linear semantics (tree.cpp:137-153): const + coeffs . x,
        # rows with NaN in a used feature fall back to leaf_value
        val = torch.where(anynan, val, const + contrib)
    score = class_sums(val * tree_w[None, :], K)
    return score, leaf


def stacked_forest_apply(stack: Dict[str, torch.Tensor], slot: torch.Tensor,
                         X: torch.Tensor, tree_w: torch.Tensor, *,
                         has_cat: bool = True, linear: bool = False,
                         levels: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score slot `slot` of a family's stacked tables (stack_tables): the
    fleet's scoring entry (serving/fleet.py). The slot is a 0-dim int32
    on the stack's device, never a host int, so one CUDA graph a rung
    serves every slot: paging a model into or out of a slot captures
    nothing. The slot's trees score the same bits as their own
    TensorForest: padding trees weigh 0, and padding iterations pad the
    fixed-order class sums exactly as the forest's own power of two
    does."""
    return forest_apply(stack, X, tree_w, has_cat=has_cat, linear=linear,
                        levels=levels, slot=slot)


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def family_key(meta: Dict[str, Any],
               tables: Dict[str, np.ndarray]) -> Tuple:
    """The shape family of a packed model (the JAX package's fleet
    _family_key): each table dimension quantized to a power of two, so
    models padding to one key share a stack and its graphs. Trees are
    quantized by whole iterations (num_class x a power of two), which
    class_sums' per-iteration order needs; with one class that is the
    JAX package's count."""
    K = int(meta["num_class"])
    d = max(int(meta["max_depth"]), 1)
    return (
        K * _pow2(-(-int(meta["num_trees"]) // K)),
        _pow2(meta["max_nodes"]),
        _pow2(meta["max_leaves"]),
        K,
        _pow2(tables["catw"].shape[0]),
        _pow2(tables["leaf_feat"].shape[2]),
        1 << (d - 1).bit_length(),
        bool(meta["has_cat"]),
        bool(meta["linear"]),
    )


def pad_forest_tables(tables, meta, *, num_trees: int, max_nodes: int,
                      max_leaves: int, cat_words: int, lin_feats: int):
    """Pad one model's host tables out to a shape family's dimensions
    (all targets >= the model's own; the JAX package's padder), so that
    models of one family share a stack. Padding reuses the packer's
    inert encodings: children -1 (straight to leaf 0), init_node -1
    (stump at leaf 0), zero leaf values and zero class-onehot rows, so
    padded trees score exactly 0 under any tree-weight vector."""
    T, M = meta["num_trees"], meta["max_nodes"]
    L = meta["max_leaves"]
    K = tables["class_onehot"].shape[1]
    Ck = tables["leaf_feat"].shape[2]
    W = tables["catw"].shape[0]
    T2, M2, L2 = int(num_trees), int(max_nodes), int(max_leaves)
    W2, Ck2 = int(cat_words), int(lin_feats)
    if min(T2 - T, M2 - M, L2 - L, W2 - W, Ck2 - Ck) < 0:
        raise ValueError("pad targets must cover the model's own dims")
    pack = np.zeros((9, T2, M2), np.float32)
    pack[5:7] = -1.0  # padding nodes route straight to leaf 0
    pack[:, :T, :M] = np.asarray(tables["pack"]).reshape(9, T, M)
    catw = np.zeros(W2, np.int32)
    catw[:W] = np.asarray(tables["catw"])
    init_node = np.full(T2, -1, np.int32)
    init_node[:T] = np.asarray(tables["init_node"])
    class_onehot = np.zeros((T2, K), np.float32)
    class_onehot[:T] = np.asarray(tables["class_onehot"])

    def grow(a, shape):
        out = np.zeros(shape, a.dtype)
        out[tuple(slice(0, s) for s in a.shape)] = a
        return out

    out = {
        "pack": pack.reshape(9, T2 * M2),
        "catw": catw,
        "leaf_value": grow(np.asarray(tables["leaf_value"]), (T2, L2)),
        "leaf_const": grow(np.asarray(tables["leaf_const"]), (T2, L2)),
        "leaf_nf": grow(np.asarray(tables["leaf_nf"]), (T2, L2)),
        "leaf_feat": grow(np.asarray(tables["leaf_feat"]), (T2, L2, Ck2)),
        "leaf_coeff": grow(np.asarray(tables["leaf_coeff"]),
                           (T2, L2, Ck2)),
        "init_node": init_node,
        "class_onehot": class_onehot,
    }
    meta2 = dict(meta, num_trees=T2, max_nodes=M2, max_leaves=L2)
    return out, meta2


def stack_tables(padded: Dict[str, np.ndarray], slots: int,
                 device) -> Dict[str, torch.Tensor]:
    """Zeroed device tables for `slots` models of one family, laid out as
    one forest of slots x T trees: a slot's node records (PACK_WIDTH
    floats a node of the padded (9, T*M) pack), catw words and per-tree
    rows are contiguous (slot_views)."""
    out = {}
    for k, v in padded.items():
        a = np.asarray(v)
        shape = ((slots * a.shape[1], PACK_WIDTH) if k == "pack"
                 else (slots * a.shape[0],) + a.shape[1:])
        out[k] = torch.zeros(shape, dtype=torch.from_numpy(a[:0]).dtype,
                             device=device)
    return out


def slot_views(stack: Dict[str, torch.Tensor], slot: int,
               slots: int) -> Dict[str, torch.Tensor]:
    """The views of one slot in stack_tables' layout."""
    out = {}
    for k, t in stack.items():
        w = t.shape[0] // slots
        out[k] = t[slot * w:(slot + 1) * w]
    return out


def pack_contrib_tables(models, num_class: int):
    """Host packing for device TreeSHAP (the JAX package's packer): per
    (tree, leaf), the root-to-leaf path as node ids + directions, the
    path's UNIQUE features with their cover ("zero") fractions. Duplicate
    features on a path collapse into one slot whose zero fraction is the
    product of its edges' cover ratios and whose one fraction is the AND
    of its edges' hot indicators (shap.py's unwind-and-re-extend). Paths
    pad with (zero=1, one=1) dummy slots, which change no other slot's
    permutation weight and contribute nothing (one - zero == 0), so the
    recursion runs at one static depth."""
    T = len(models)
    K = max(int(num_class), 1)
    n_nodes = [max(t.num_leaves - 1, 0) for t in models]
    M = max(n_nodes + [1])
    L = max([t.num_leaves for t in models] + [1])

    paths: Dict[Tuple[int, int], List[Tuple[int, int, float, int]]] = {}
    expect = np.zeros(T, np.float32)
    for ti, t in enumerate(models):
        lv = np.asarray(t.leaf_value, np.float64)
        if t.num_leaves == 1:
            expect[ti] = lv[0]
            continue
        cnt_in = np.asarray(t.internal_count, np.float64)
        cnt_lf = np.asarray(t.leaf_count, np.float64)
        total = cnt_in[0]
        expect[ti] = (
            float(np.dot(cnt_lf[: t.num_leaves] / total,
                         lv[: t.num_leaves]))
            if total > 0 else float(np.mean(lv[: t.num_leaves]))
        )

        def count(n: int) -> float:
            return cnt_in[n] if n >= 0 else cnt_lf[~n]

        # iterative DFS: (node, edges so far); edge = (node, dir,
        # cover ratio, feature)
        stack: List[Tuple[int, List[Tuple[int, int, float, int]]]] = [
            (0, [])
        ]
        while stack:
            node, edges = stack.pop()
            if node < 0:
                paths[(ti, ~node)] = edges
                continue
            w = count(node)
            f = int(t.split_feature[node])
            for child, d in ((int(t.left_child[node]), 1),
                             (int(t.right_child[node]), 0)):
                r = count(child) / w if w > 0 else 0.0
                stack.append((child, edges + [(node, d, r, f)]))

    E = _pow2(max([len(e) for e in paths.values()] + [1]))
    P = _pow2(max(
        [len({f for _, _, _, f in e}) for e in paths.values()] + [1]
    ))
    nodes = np.full((T, L, E), -1, np.int32)
    dirs = np.zeros((T, L, E), np.float32)
    slot_oh = np.zeros((T, L, E, P), np.float32)
    zero = np.ones((T, L, P), np.float32)
    feat = np.zeros((T, L, P), np.int32)
    for (ti, li), edges in paths.items():
        slots: Dict[int, int] = {}
        for e, (node, d, r, f) in enumerate(edges):
            s = slots.setdefault(f, len(slots))
            nodes[ti, li, e] = ti * M + node
            dirs[ti, li, e] = d
            slot_oh[ti, li, e, s] = 1.0
            zero[ti, li, s] *= r
            feat[ti, li, s] = f
    tables = {
        "nodes": nodes,          # (T, L, E) int32, flat t*M+node, pad -1
        "dirs": dirs,            # (T, L, E) f32, 1 = path goes left
        "slot_oh": slot_oh,      # (T, L, E, P) f32 edge -> feature slot
        "zero": zero,            # (T, L, P) f32 cover fractions, pad 1
        "feat": feat,            # (T, L, P) int32 feature ids, pad 0
        "expect": expect,        # (T,) f32 cover-weighted mean output
        "tree_class": (np.arange(T, dtype=np.int32) % K),  # (T,)
    }
    cmeta = {"path_edges": int(E), "path_feats": int(P),
             "max_nodes": M, "max_leaves": L}
    return tables, cmeta


def contrib_apply(tables: Dict[str, torch.Tensor],
                  ctables: Dict[str, torch.Tensor], X: torch.Tensor,
                  tree_w: torch.Tensor, *, has_cat: bool = True
                  ) -> torch.Tensor:
    """Device TreeSHAP: (N, F) rows -> (N, K*(F+1)) f64 contributions in
    Booster.predict(pred_contrib=True) layout (per class: F feature
    columns then the expected-value bias column; rows sum to the raw
    score). One split decision per (row, node), per-leaf one / zero
    fractions, then the extend / unwound-sum recursion over every (row,
    tree, leaf) lane at one static path depth."""
    T, L = tables["leaf_value"].shape
    M = tables["pack"].shape[0] // T
    N, F = X.shape
    K = tables["class_onehot"].shape[1]
    P = ctables["zero"].shape[2]
    E = ctables["nodes"].shape[2]
    tw = tree_w.to(torch.float32)

    # the split decision at EVERY node (the traversal evaluates only the
    # visited one; SHAP weighs both branches of every path)
    v = tables["pack"].T[:PACK_FIELDS, None, :]  # (9, 1, T*M) columns
    x_all = torch.index_select(X, 1, v[0, 0].long())             # (N, T*M)
    gl = go_left(v, x_all, tables["catw"], has_cat)              # (N, T*M)

    nodes = ctables["nodes"]
    nid = nodes.clamp(min=0).reshape(-1).long()
    g = torch.index_select(gl, 1, nid).view(N, T, L, E)
    follows = torch.where(nodes[None] < 0, True,
                          g == (ctables["dirs"][None] > 0.5))
    miss = (~follows).to(torch.float32)                          # (N,T,L,E)
    # a slot is "hot" (one fraction 1) iff the row follows the path at
    # every edge splitting on that slot's feature (sums of 0 / 1: exact)
    o = (torch.einsum("ntle,tlep->ntlp", miss, ctables["slot_oh"])
         == 0).to(torch.float32)
    z = ctables["zero"]                                          # (T, L, P)

    # extend (shap.py _extend): permutation weights w[0..P] per lane
    w = [torch.ones((N, T, L), dtype=torch.float32, device=X.device)]
    for i in range(1, P + 1):
        one = o[..., i - 1]
        zr = z[None, :, :, i - 1]
        w.append(torch.zeros_like(w[0]))
        d1 = float(i + 1)
        for j in range(i - 1, -1, -1):
            w[j + 1] = w[j + 1] + one * w[j] * ((j + 1) / d1)
            w[j] = zr * w[j] * ((i - j) / d1)

    # per-slot unwound sums (shap.py _unwound_sum at depth P) -> phi
    lv = tables["leaf_value"]
    d1 = float(P + 1)
    deltas = []
    for i in range(P):
        one = o[..., i]
        zr = z[None, :, :, i]
        zsafe = zr.clamp(min=1e-12)
        hot = one > 0.5
        nxt = w[P]
        total = torch.zeros_like(w[0])
        for j in range(P - 1, -1, -1):
            tmp = nxt * (d1 / (j + 1))
            cold = (w[j] / zsafe) * (d1 / (P - j))
            total = total + torch.where(hot, tmp, cold)
            nxt = torch.where(hot, w[j] - tmp * zr * ((P - j) / d1), nxt)
        deltas.append(total * (one - zr) * lv[None] * tw[None, :, None])
    delta = torch.stack(deltas, dim=-1)                          # (N,T,L,P)

    # the columns sum every (tree, leaf, slot) lane of their feature: in
    # f64, so the f32 lanes' rounding, not the long sums', bounds the
    # error against host TreeSHAP
    cols = (ctables["tree_class"][:, None, None] * (F + 1)
            + ctables["feat"])                                   # (T, L, P)
    out = torch.zeros((N, K * (F + 1)), dtype=torch.float64,
                      device=X.device)
    out.index_add_(1, cols.reshape(-1).long(),
                   delta.reshape(N, -1).to(torch.float64))
    bias = class_sums((tw.double() * ctables["expect"].double())[None, :],
                      K)[0]                                      # (K,)
    bcols = (torch.arange(K, device=X.device) + 1) * (F + 1) - 1
    out[:, bcols] += bias[None, :]
    return out


class TensorForest:
    """A trained forest as device tables and its scoring calls.

    apply() is the raw call on an already padded f32 block of rows on
    the forest's device; predict_raw / predict_leaf / predict_contrib
    take host numpy rows, as Booster.predict does. The contrib tables are
    packed on the first contrib request only. mesh: a Mesh of more than
    one rank shards every call's rows over its ranks (module docstring);
    every rank must make the same calls in the same order."""

    def __init__(self, models, num_class: int = 1,
                 average_output: bool = False, device="cuda", mesh=None):
        if not models:
            raise ValueError("TensorForest needs at least one tree")
        self.device = serve_device(device)
        tables, meta = pack_forest_tables(models, num_class)
        self.meta = meta
        # retained for lazy contrib packing (references, not copies)
        self._models = list(models)
        self._ctables = None
        # every lane descends one edge a level: the forest's max depth
        # bounds the traversal
        self.levels = max(int(meta["max_depth"]), 1)
        self.num_class = meta["num_class"]
        self.num_trees = meta["num_trees"]
        self.average_output = bool(average_output)
        self.max_feature = meta["max_feature"]
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.num_devices = 1 if self.mesh is None else self.mesh.size
        self.weight_len = self.num_trees  # the (T,) tree weights apply takes
        self.tables = device_tables(tables, self.device)

    def bind(self) -> None:
        """Make this forest the one a dispatcher's programs score: a
        TensorForest owns its tables, so nothing to do (a fleet tenant
        writes its slot, serving/fleet.py)."""

    @classmethod
    def from_booster(cls, booster, device="cuda", mesh=None
                     ) -> "TensorForest":
        g = booster._gbdt
        return cls(list(g.models), g.num_class,
                   average_output=bool(getattr(g, "average_output", False)),
                   device=device, mesh=mesh)

    def _tree_weights(self, start_iteration: int,
                      num_iteration: int) -> Tuple[np.ndarray, int, int]:
        K = self.num_class
        n_iters = self.num_trees // K
        end = n_iters if num_iteration <= 0 else min(
            n_iters, start_iteration + num_iteration
        )
        tw = np.zeros(self.num_trees, np.float32)
        tw[start_iteration * K: end * K] = 1.0
        return tw, start_iteration, end

    def _check_width(self, X: np.ndarray) -> None:
        if X.shape[1] <= self.max_feature:
            # the host walk's error on narrow input (tree.py predict_leaf
            # raises IndexError)
            raise IndexError(
                f"input has {X.shape[1]} features but the model "
                f"references feature {self.max_feature}"
            )

    def _rows(self, X) -> np.ndarray:
        X = np.ascontiguousarray(np.asarray(X, np.float32))
        if X.ndim == 1:
            X = X.reshape(1, -1)
        self._check_width(X)
        return X

    def apply(self, X: torch.Tensor, tree_w: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Raw call on an f32 (N, F) block on the forest's device: scores
        (N, K) and leaves (N, T)."""
        return self._sharded(lambda x: forest_apply(
            self.tables, x, tree_w, has_cat=self.meta["has_cat"],
            linear=self.meta["linear"], levels=self.levels), X)

    def _sharded(self, fn, X: torch.Tensor):
        """fn over X's rows: directly, or under a mesh on this rank's
        block of ceil(N / n) rows (zero rows pad the last), every rank's
        outputs all-gathered back into row order."""
        if self.mesh is None:
            return fn(X)
        n, r = self.mesh.size, self.mesh.rank
        N = X.shape[0]
        blk = -(-N // n)
        mine = X[min(r * blk, N):min((r + 1) * blk, N)]
        if mine.shape[0] < blk:
            mine = torch.cat([mine, torch.zeros(
                (blk - mine.shape[0],) + tuple(X.shape[1:]), dtype=X.dtype,
                device=X.device)])
        outs = fn(mine)
        single = isinstance(outs, torch.Tensor)
        gathered = [
            self.mesh.all_gather(o).reshape((n * blk,) + tuple(o.shape[1:]))
            [:N].to(o.dtype)
            for o in ((outs,) if single else outs)]
        return gathered[0] if single else tuple(gathered)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def predict_raw(self, X, start_iteration: int = 0,
                    num_iteration: int = -1) -> np.ndarray:
        """(K, N) raw margins, matching GBDT.predict_raw layout."""
        X = self._rows(X)
        tw, start, end = self._tree_weights(start_iteration, num_iteration)
        score, _ = self.apply(self._tensor(X), self._tensor(tw))
        out = score.cpu().numpy().T.astype(np.float64)  # (K, N)
        if self.average_output and end > start:
            out /= end - start
        return out

    def predict_leaf(self, X, start_iteration: int = 0,
                     num_iteration: int = -1) -> np.ndarray:
        """(N, used_trees) leaf indices (Booster.predict pred_leaf)."""
        X = self._rows(X)
        tw, start, end = self._tree_weights(start_iteration, num_iteration)
        _, leaf = self.apply(self._tensor(X), self._tensor(tw))
        K = self.num_class
        return leaf.cpu().numpy()[:, start * K: end * K].astype(np.int64)

    # -------------------------------------------------------- contrib
    def contrib_tables(self):
        """The device TreeSHAP tables, packed on first use."""
        if self._ctables is None:
            ct, cmeta = pack_contrib_tables(self._models, self.num_class)
            self._ctables = (
                {k: torch.from_numpy(np.ascontiguousarray(v))
                 .to(self.device) for k, v in ct.items()}, cmeta)
        return self._ctables

    def drop_contrib_tables(self) -> None:
        self._ctables = None

    def apply_contrib(self, X: torch.Tensor, tree_w: torch.Tensor
                      ) -> torch.Tensor:
        """Raw device TreeSHAP on an f32 block on the forest's device:
        (N, K*(F+1)) where F is the block's width."""
        ct, _ = self.contrib_tables()
        return self._sharded(lambda x: contrib_apply(
            self.tables, ct, x, tree_w, has_cat=self.meta["has_cat"]), X)

    def predict_contrib(self, X, start_iteration: int = 0,
                        num_iteration: int = -1) -> np.ndarray:
        """(N, K*(F+1)) SHAP contributions in Booster.predict
        (pred_contrib=True) layout; host shap.py is the oracle."""
        X = self._rows(X)
        tw, start, end = self._tree_weights(start_iteration, num_iteration)
        out = self.apply_contrib(self._tensor(X), self._tensor(tw))
        out = out.cpu().numpy().astype(np.float64)
        if self.average_output and end > start:
            out /= end - start
        return out
