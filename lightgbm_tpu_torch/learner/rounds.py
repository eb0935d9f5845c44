"""Natural-order round-batched leaf-wise growth on one device.

The port of lightgbm_tpu/learner/rounds.py (grow_tree_rounds, the
single production grower of the JAX package) for axis_name=None, with
integer gradient levels (spec.quant: the default int16 path, and
use_quantized_grad, whose levels within +-127 ride the kernels' int8
mode, spec.quant_int8) or f32 gradients (tpu_hist_dtype=bf16x2). Rows
never move: the partition is a per-row leaf-id vector. Each round
- picks the top-k positive-gain leaves (k bounded by the remaining leaf
  budget, the kernel width of the S-ladder, and, on small data, half the
  remaining budget — rounds.py:415-459);
- runs ONE fused pass (histogram.hist_round: the hist_round kernel on
  the card) that partitions those leaves' rows and builds the smaller
  children's histograms;
- gets each larger child by parent subtraction, and searches the best
  split of all new children in one batched call.

The JAX loop is a lax.while_loop; here it is a Python loop with one
host read per round (the count of splittable leaves, which also picks
the ladder width). lax.top_k's lower-index-first tie order comes from a
stable descending sort. `.at[...].set(mode="drop")` scatters become
writes at the taken prefix of the gain-sorted slots, which the JAX
formulation guarantees: taken slots are exactly slots 0..n_split-1.

Categorical splits ride the same loop: the split records and node
tables carry is_cat and the (B,) left category set, and with
spec.has_cat the fused pass takes the round's per-slot sets (params
column 10 flags a categorical slot; hist_round's categorical mode).

Not ported, each refused upstream: voting / reduce-scatter / any mesh
axis, per-node extras (extra_trees, feature_fraction_bynode, CEGB,
interaction constraints), monotone intermediate and advanced, and
forced splits (ROADMAP queue A). Monotone basic is kept: it costs
nothing beyond the interval tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .bundle import BundleInfo, expand_hist
from .grower import (
    GrowerSpec,
    TreeArrays,
    empty_tree,
    monotone_child_intervals,
    split_leaf_outputs,
)
from .histogram import build_gh3, build_gh8_quant, hist_nat_slots, \
    hist_round, histogram, root_sums, root_sums_quant
from .split import BIG, NEG_INF, SplitParams, SplitRecord, best_split, \
    leaf_output, map_record

_TAIL_EXACT_ROWS = 32 * 8192  # rounds.py:436


def _scatter(dst: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    out = dst.clone()
    out[idx] = val
    return out


def grow_tree_rounds(
    bins_fm: torch.Tensor,  # (G, N) int32, natural row order
    nan_bin: torch.Tensor,  # (F,) int32
    num_bins: torch.Tensor,  # (F,) int32
    mono: torch.Tensor,  # (F,) int32
    is_cat: torch.Tensor,  # (F,) bool
    grad: torch.Tensor,  # (N,) f32 INTEGER levels (spec.quant) or values
    hess: torch.Tensor,  # (N,) f32 INTEGER levels (spec.quant) or values
    mask: torch.Tensor,  # (N,) f32 validity * bagging
    feat_mask: torch.Tensor,  # (F,) bool
    params: SplitParams,
    spec: GrowerSpec,
    valid: Optional[torch.Tensor] = None,
    bundle: Optional[BundleInfo] = None,
    gh_scale: Optional[torch.Tensor] = None,  # (2,) [g_scale, h_scale]
) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree -> (tree arrays, natural-order row -> leaf, -1 on
    rows with valid == 0). gh_scale carries the level scales when
    spec.quant and must be None otherwise."""
    if spec.quant != (gh_scale is not None):
        raise ValueError("gh_scale is required with spec.quant (integer "
                         "levels) and refused without it")
    L = spec.num_leaves
    B = spec.num_bins
    G, N = bins_fm.shape
    dev = bins_fm.device
    S = min(spec.rounds_slots, max(L - 1, 1))
    Bc = spec.col_bins if (spec.efb and spec.col_bins) else B
    widths = tuple(w for w in (8, 32) if w < S) + (S,)
    tail_exact = N <= _TAIL_EXACT_ROWS
    levels = spec.quant_levels
    has_mono = spec.has_mono
    # a dataset without categorical features skips their search
    cat_arg = is_cat if spec.has_cat else None

    def exp_hist(h, g_, h_, c_):
        return expand_hist(h, g_, h_, c_, bundle) if spec.efb else h

    if spec.quant:
        # (3, N) int8 in the int8 mode (spec.quant_int8), else int32
        gh = build_gh8_quant(grad * mask, hess * mask, mask,
                             int8_levels=levels if spec.quant_int8 else 0)
        scale3 = torch.stack([gh_scale[0], gh_scale[1],
                              torch.ones((), dtype=torch.float32,
                                         device=dev)])
        root = root_sums_quant(gh) * scale3  # (3,)
        hist0 = hist_nat_slots(bins_fm, gh,
                               torch.zeros(N, dtype=torch.int32, device=dev),
                               1, Bc, levels=levels)[0]
        hist0 = hist0 * scale3[:, None, None]
    else:
        gh = build_gh3(grad * mask, hess * mask, mask)  # (3, N) f32
        root = root_sums(gh)
        hist0 = histogram(bins_fm, gh, Bc)
    root_out = leaf_output(root[0], root[1], params)
    big = torch.full((1,), BIG, dtype=torch.float32, device=dev)
    rec0 = best_split(
        exp_hist(hist0[None], root[0:1], root[1:2], root[2:3]),
        root[0:1], root[1:2], root[2:3], num_bins, nan_bin, mono, params,
        feat_mask, parent_output=root_out[None],
        cmin=-big if has_mono else None, cmax=big if has_mono else None,
        has_mono=has_mono, is_cat=cat_arg, cat_subset=spec.cat_subset,
    )

    hist = torch.zeros((L, 3, G, Bc), dtype=torch.float32, device=dev)
    hist[0] = hist0
    zf = lambda: torch.zeros(L, dtype=torch.float32, device=dev)
    zi = lambda: torch.zeros(L, dtype=torch.int32, device=dev)
    best = SplitRecord(
        gain=torch.full((L,), NEG_INF, dtype=torch.float32, device=dev),
        feature=zi(), bin=zi(),
        default_left=torch.zeros(L, dtype=torch.bool, device=dev),
        is_cat=(torch.zeros(L, dtype=torch.bool, device=dev)
                if spec.has_cat else None),
        cat_mask=(torch.zeros((L, B), dtype=torch.bool, device=dev)
                  if spec.has_cat else None),
        left_g=zf(), left_h=zf(), left_c=zf(),
        right_g=zf(), right_h=zf(), right_c=zf(),
    )
    best = map_record(lambda b, r: _scatter(b, 0, r[0]), best, rec0)
    t = empty_tree(L, B, dev)
    t = t._replace(
        leaf_value=_scatter(t.leaf_value, 0, root_out),
        leaf_weight=_scatter(t.leaf_weight, 0, root[1]),
        leaf_count=_scatter(t.leaf_count, 0, root[2]),
    )
    valid_f = (torch.ones(N, dtype=torch.float32, device=dev)
               if valid is None else valid)
    pleaf = torch.where(valid_f > 0, 0, L).to(torch.int32)
    leaf_g = _scatter(zf(), 0, root[0])
    leaf_h = _scatter(zf(), 0, root[1])
    leaf_c = _scatter(zf(), 0, root[2])
    leaf_parent = torch.full((L,), -1, dtype=torch.int64, device=dev)
    leaf_min = torch.full((L,), -BIG, dtype=torch.float32, device=dev)
    leaf_max = torch.full((L,), BIG, dtype=torch.float32, device=dev)

    i = 0
    while True:
        n_pos, any_pos = torch.stack([
            (best.gain > 0.0).sum(), (best.gain.max() > 0.0).to(torch.int64),
        ]).tolist()
        if i >= L - 1 or not any_pos:
            break
        budget0 = (L - 1) - i
        n_cand = min(budget0, n_pos)
        if tail_exact:
            n_cand = min(n_cand, max((budget0 + 1) // 2, 1))
        Sk = widths[sum(n_cand > w for w in widths[:-1])]
        n_split = min(budget0, Sk, n_cand)

        # ---- select: top-k by gain, lower leaf index first on ties
        order = torch.sort(best.gain, descending=True, stable=True).indices
        tl = order[:n_split]  # taken leaves, gain-sorted
        node_ids = i + torch.arange(n_split, device=dev)
        new_ids = node_ids + 1
        rec = map_record(lambda f: f[tl], best)

        # ---- outputs / monotone intervals of the taken splits
        pmin, pmax = leaf_min[tl], leaf_max[tl]
        lo, ro = split_leaf_outputs(
            rec, params, t.leaf_value[tl],
            pmin if has_mono else None, pmax if has_mono else None,
            num_bins, spec.cat_subset)
        if has_mono:
            lmin, lmax, rmin, rmax = monotone_child_intervals(
                rec.feature, rec.is_cat, mono, lo, ro, pmin, pmax)
        depth_new = t.leaf_depth[tl] + 1

        # ---- tree bookkeeping (Tree::Split, batched)
        p = leaf_parent[tl]
        has_p = p >= 0
        pc = p.clamp_min(0)
        p_is_left = t.node_left[pc] == ~tl.to(torch.int32)
        node_left = t.node_left.clone()
        node_right = t.node_right.clone()
        nid32 = node_ids.to(torch.int32)
        fix_l, fix_r = has_p & p_is_left, has_p & ~p_is_left
        node_left[pc[fix_l]] = nid32[fix_l]
        node_right[pc[fix_r]] = nid32[fix_r]
        node_left[node_ids] = ~tl.to(torch.int32)
        node_right[node_ids] = ~new_ids.to(torch.int32)
        t = TreeArrays(
            num_nodes=torch.tensor(i + n_split, dtype=torch.int32,
                                   device=dev),
            node_feature=_scatter(t.node_feature, node_ids, rec.feature),
            node_bin=_scatter(t.node_bin, node_ids, rec.bin),
            node_gain=_scatter(t.node_gain, node_ids, rec.gain),
            node_default_left=_scatter(t.node_default_left, node_ids,
                                       rec.default_left),
            node_cat=(_scatter(t.node_cat, node_ids, rec.is_cat)
                      if spec.has_cat else t.node_cat),
            node_cat_mask=(_scatter(t.node_cat_mask, node_ids, rec.cat_mask)
                           if spec.has_cat else t.node_cat_mask),
            node_left=node_left,
            node_right=node_right,
            node_value=_scatter(t.node_value, node_ids, t.leaf_value[tl]),
            node_weight=_scatter(t.node_weight, node_ids, leaf_h[tl]),
            node_count=_scatter(t.node_count, node_ids, leaf_c[tl]),
            leaf_value=_scatter(_scatter(t.leaf_value, tl, lo), new_ids, ro),
            leaf_weight=_scatter(_scatter(t.leaf_weight, tl, rec.left_h),
                                 new_ids, rec.right_h),
            leaf_count=_scatter(_scatter(t.leaf_count, tl, rec.left_c),
                                new_ids, rec.right_c),
            leaf_depth=_scatter(_scatter(t.leaf_depth, tl, depth_new),
                                new_ids, depth_new),
        )

        # ---- the fused pass: partition + smaller-child histograms
        left_smaller = rec.left_c <= rec.right_c  # (n_split,)
        feat = rec.feature.long()
        col = bundle.bundle_of[feat] if spec.efb else rec.feature
        params16 = torch.zeros((Sk, 16), dtype=torch.int32, device=dev)
        params16[:, 0] = -1
        params16[:n_split, 0] = tl.to(torch.int32)
        params16[:n_split, 1] = col
        params16[:n_split, 2] = rec.bin
        params16[:n_split, 3] = rec.default_left.to(torch.int32)
        params16[:n_split, 4] = nan_bin[feat]
        params16[:n_split, 5] = left_smaller.to(torch.int32)
        params16[:n_split, 6] = new_ids.to(torch.int32)
        if spec.efb:
            params16[:n_split, 7] = bundle.off_lo[feat]
            params16[:n_split, 8] = bundle.mfb[feat]
            params16[:n_split, 9] = bundle.width[feat]
        else:
            params16[:, 8] = -1
        cat_mask = None
        if spec.has_cat:
            params16[:n_split, 10] = rec.is_cat.to(torch.int32)
            # (Sk, Bc): the kernel's bin space is the bundle width
            cat_mask = torch.zeros((Sk, Bc), dtype=torch.bool, device=dev)
            cat_mask[:n_split, :B] = rec.cat_mask
        slot_hists, pleaf = hist_round(bins_fm, gh, pleaf, params16, Sk, Bc,
                                       L, quant=spec.quant,
                                       cat_mask=cat_mask, levels=levels)
        parent_s = hist[tl]
        if spec.quant:
            sums = slot_hists[:n_split]  # exact integer sums
            small = sums * scale3[:, None, None]
            # ---- larger child by parent subtraction. parent - sums *
            # scale with ONE rounding: XLA contracts the JAX package's
            # multiply-subtract into a fused multiply-add, and the
            # integer sums times an f32 scale are exact in f64
            large = (parent_s.double() - sums.double()
                     * scale3.double()[:, None, None]).float()
        else:
            small = slot_hists[:n_split]
            large = parent_s - small
        ls = left_smaller[:, None, None, None]
        left_s = torch.where(ls, small, large)
        right_s = torch.where(ls, large, small)
        hist[tl] = left_s
        hist[new_ids] = right_s

        leaf_g = _scatter(_scatter(leaf_g, tl, rec.left_g), new_ids,
                          rec.right_g)
        leaf_h = _scatter(_scatter(leaf_h, tl, rec.left_h), new_ids,
                          rec.right_h)
        leaf_c = _scatter(_scatter(leaf_c, tl, rec.left_c), new_ids,
                          rec.right_c)

        # ---- best splits of the 2 n_split new children, one batch
        ch_g = torch.cat([rec.left_g, rec.right_g])
        ch_h = torch.cat([rec.left_h, rec.right_h])
        ch_c = torch.cat([rec.left_c, rec.right_c])
        ch_po = torch.cat([lo, ro])
        if has_mono:
            ch_mn, ch_mx = torch.cat([lmin, rmin]), torch.cat([lmax, rmax])
        else:
            ch_mn = ch_mx = None
        ch_rec = best_split(
            exp_hist(torch.cat([left_s, right_s]), ch_g, ch_h, ch_c),
            ch_g, ch_h, ch_c, num_bins, nan_bin, mono, params, feat_mask,
            parent_output=ch_po, cmin=ch_mn, cmax=ch_mx, has_mono=has_mono,
            is_cat=cat_arg, cat_subset=spec.cat_subset,
        )
        depth_ok = (torch.ones_like(depth_new, dtype=torch.bool)
                    if spec.max_depth <= 0 else depth_new < spec.max_depth)
        ch_gain = torch.where(torch.cat([depth_ok, depth_ok]), ch_rec.gain,
                              torch.full_like(ch_rec.gain, NEG_INF))
        ch_leaf = torch.cat([tl, new_ids])
        best = map_record(lambda b, v: _scatter(b, ch_leaf, v), best,
                          ch_rec._replace(gain=ch_gain))
        if has_mono:
            leaf_min = _scatter(_scatter(leaf_min, tl, lmin), new_ids, rmin)
            leaf_max = _scatter(_scatter(leaf_max, tl, lmax), new_ids, rmax)
        leaf_parent = _scatter(_scatter(leaf_parent, tl, node_ids), new_ids,
                               node_ids)
        i += n_split

    row_leaf = pleaf
    if valid is not None:
        row_leaf = torch.where(valid > 0, row_leaf,
                               torch.full_like(row_leaf, -1))
    return t, row_leaf
