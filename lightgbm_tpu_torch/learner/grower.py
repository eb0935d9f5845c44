"""Tree arrays, growth spec and the per-tree helpers shared by the grower.

The port of lightgbm_tpu/learner/grower.py: the fixed-size tree layout
of the reference (include/LightGBM/tree.h; child pointers >= 0 are
internal nodes, < 0 leaves as ~leaf), the leaf output math of a chosen
split, the basic monotone intervals and the intermediate / advanced
bounds (mono_bounds), the score update through the row -> leaf vector,
the per-node split candidates (make_node_candidates:
interaction constraints, feature_fraction_bynode, extra_trees and the
CEGB penalties) and the forced-split plan both growers share, and
grow_tree's dispatch between the rounds grower (rounds.py) and the
sequential permuted grower (permuted.py). The JAX package's flat grower
is not ported: feature-parallel growth rides the permuted grower
(parallel/feature_parallel.py).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from .. import rng
from .split import BIG, SplitParams, SplitRecord, leaf_gain, leaf_output


class GrowerSpec(NamedTuple):
    """Static growth configuration of a tree."""

    num_leaves: int
    num_bins: int  # uniform per-feature bin-axis size B
    max_depth: int  # <= 0 means unlimited
    # > 0: the rounds grower, splitting this many leaves per round at most
    # (kernel width); 0: the sequential permuted grower
    rounds_slots: int
    efb: bool = False  # bin matrix columns are EFB bundles
    col_bins: int = 0  # bundle-column bin axis (0 = num_bins)
    quant_levels: int = 256  # integer levels of the gradient channels
    has_mono: bool = False  # any monotone constraint
    # monotone_constraints_method (the JAX package's mono_mode,
    # grower.py:136-150): 0 basic (children bounded at the split's
    # midpoint), 1 intermediate (every leaf's bounds recomputed from the
    # opposite subtrees' output extrema after each split or round, and
    # every leaf's best split searched again under them), 2 advanced
    # (rounds grower only: those extrema taken only over leaves whose
    # per-feature bin ranges can meet, monotone_constraints.hpp:858)
    mono_mode: int = 0
    # rounds grower: integer-level channels (True) or f32 channels
    quant: bool = True
    # integer levels within +-127 ride the kernels' int8 mode
    # (use_quantized_grad <= 127 levels, tpu_hist_dtype=int8)
    quant_int8: bool = False
    # permuted grower: the batched round phase first (tpu_growth_rounds)
    rounds: bool = False
    # sorted-subset categorical splits (feature_histogram.hpp:449): set
    # when the dataset has categorical features wider than
    # max_cat_to_onehot; False keeps every categorical one-vs-rest
    cat_subset: bool = False
    # the dataset has a categorical feature: the split search tries the
    # categorical directions and the rounds grower's fused pass takes the
    # per-slot category sets (hist_round's categorical mode)
    has_cat: bool = False
    # per-node extras (make_node_candidates): one random numerical
    # threshold per feature and node (extra_trees), a per-node feature
    # subsample (feature_fraction_bynode < 1), the CEGB penalties, and
    # the number of interaction-constraint groups (0 = unconstrained)
    extra_trees: bool = False
    ff_bynode: bool = False
    cegb: bool = False
    n_groups: int = 0
    # length of the forced-split plan (forcedsplits_filename), 0 = none
    n_forced: int = 0
    # a sharded run (the JAX spec's axis_name / axis_size, voting_k and
    # feature_axis, grower.py:54,97-102): here an axis is a
    # parallel.comm.Mesh rather than a name. axis_name: the data axis
    # (rows sharded, histograms reduced); voting_k > 0 elects 2 * k
    # columns a round (voting-parallel); feature_axis: every rank holds
    # every row and searches its own feature block (feature-parallel,
    # exact grower)
    axis_name: Optional[Any] = None
    axis_size: int = 1
    voting_k: int = 0
    feature_axis: Optional[Any] = None
    # the rows a single device holding every rank's rows pads to: the n
    # of the f32 histograms' fixed-point scale under a data axis, so
    # each rank's int64 partials sum to that device's bits
    axis_rows: int = 0

    @property
    def per_node(self) -> bool:
        return bool(self.extra_trees or self.ff_bynode or self.cegb
                    or self.n_groups)


class CegbInfo(NamedTuple):
    """CEGB penalty tables over the used features
    (cost_effective_gradient_boosting.hpp)."""

    coupled: torch.Tensor  # (F,) f32 — once per feature, model-wide
    lazy: torch.Tensor  # (F,) f32 — per row, along each tree path
    used: torch.Tensor  # (F,) bool — features earlier trees split on


class ForcedSplits(NamedTuple):
    """A forced-split plan (serial_tree_learner.cpp:627 ForceSplits): the
    BFS-ordered (leaf, feature, bin) of each prescribed split, leaf ids
    laid out as Tree::Split numbers them (the JAX package's
    permuted.ForcedSplits); device tensors, so a CUDA graph reads them."""

    leaf: torch.Tensor  # (n,) int32 — leaf id when the split applies
    feature: torch.Tensor  # (n,) int32 — used-feature index
    bin: torch.Tensor  # (n,) int32 — threshold bin
    n: int


class TreeArrays(NamedTuple):
    """Fixed-size tree (node arrays num_leaves-1 long, leaf arrays
    num_leaves long), the JAX package's TreeArrays field for field."""

    num_nodes: torch.Tensor  # scalar int32 — splits performed
    node_feature: torch.Tensor
    node_bin: torch.Tensor
    node_gain: torch.Tensor
    node_default_left: torch.Tensor
    node_cat: torch.Tensor
    node_cat_mask: torch.Tensor  # (L-1, B) bool
    node_left: torch.Tensor
    node_right: torch.Tensor
    node_value: torch.Tensor
    node_weight: torch.Tensor
    node_count: torch.Tensor
    leaf_value: torch.Tensor
    leaf_weight: torch.Tensor
    leaf_count: torch.Tensor
    leaf_depth: torch.Tensor


def make_split_params(cfg) -> SplitParams:
    """Split hyper-parameters from a Config, rounded to f32 as the JAX
    package's traced params are."""
    import numpy as np

    f = lambda v: float(np.float32(v))
    return SplitParams(
        lambda_l1=f(cfg.lambda_l1),
        lambda_l2=f(cfg.lambda_l2),
        min_data_in_leaf=f(cfg.min_data_in_leaf),
        min_sum_hessian_in_leaf=f(cfg.min_sum_hessian_in_leaf),
        min_gain_to_split=f(cfg.min_gain_to_split),
        max_delta_step=f(cfg.max_delta_step),
        path_smooth=f(cfg.path_smooth),
        cat_smooth=f(cfg.cat_smooth),
        cat_l2=f(cfg.cat_l2),
        max_cat_threshold=int(cfg.max_cat_threshold),
        max_cat_to_onehot=int(cfg.max_cat_to_onehot),
        min_data_per_group=f(cfg.min_data_per_group),
        cegb_tradeoff=f(cfg.cegb_tradeoff),
        cegb_penalty_split=f(cfg.cegb_penalty_split),
        feature_fraction_bynode=f(cfg.feature_fraction_bynode),
    )


def make_node_candidates(spec: GrowerSpec, params: SplitParams, feat_mask,
                         num_bins, nan_bin, rng_key, group_mat,
                         cegb: Optional[CegbInfo]):
    """The per-node split candidates both growers share (the JAX
    package's make_node_candidates, grower.py:265): interaction-group
    filtering, the feature_fraction_bynode subsample, extra_trees' random
    thresholds and the CEGB DeltaGain penalty (with its per-tree-path
    lazy approximation). Returns node_candidates(salts, groups,
    path_used, count, feat_used) -> (feat_mask, rand_bin, penalty), each
    (n, F) or None, for a batch of n nodes at once (the JAX package vmaps
    it over a round's children): salts (n,) the node keys, groups
    (n, NG) the constraint groups still legal, path_used (n, F) the
    features on each node's path, count (n,) its rows, feat_used (F,)
    the features used anywhere so far. The draws are the JAX package's
    bits: fold_in(rng_key, 2 * salt) then uniform(F) for the subsample,
    2 * salt + 1 for the thresholds."""
    F = num_bins.shape[0]

    def node_candidates(salts, groups, path_used, count, feat_used):
        n = salts.shape[0]
        fm = feat_mask[None].expand(n, F)
        rb = pen = None
        if spec.n_groups:
            fm = fm & (group_mat[None] & groups[:, :, None]).any(dim=1)
        # both draws of every node in one batch (the same bits as one
        # draw at a time, at half the device operations)
        words = [2 * salts] * spec.ff_bynode + [2 * salts + 1] * \
            spec.extra_trees
        if words:
            draws = rng.uniform_many(
                rng.fold_in_many(rng_key, torch.cat(words)), F)
        if spec.ff_bynode:
            # ceil(frac * valid) of the still-valid features, at least one
            # (ColSampler samples from used_feature_indices_)
            u = draws[:n]
            u = torch.where(fm, u, torch.full_like(u, float("inf")))
            n_valid = fm.sum(dim=1).to(torch.float32)
            n_pick = torch.clamp_min(torch.ceil(
                params.feature_fraction_bynode * n_valid).to(torch.int64), 1)
            rank = torch.argsort(torch.argsort(u, dim=1, stable=True),
                                 dim=1, stable=True)
            fm = fm & (rank < n_pick[:, None])
        if spec.extra_trees:
            u = draws[-n:]
            n_thr = torch.clamp_min(
                num_bins - 1 - (nan_bin >= 0).to(num_bins.dtype), 1)
            rb = torch.floor(u * n_thr.to(torch.float32)).to(torch.int32)
        if spec.cegb:
            c = count.to(torch.float32)[:, None]
            pen = params.cegb_tradeoff * (
                params.cegb_penalty_split * c
                + cegb.coupled[None] * (~feat_used).to(torch.float32)[None]
                + cegb.lazy[None] * c * (~path_used).to(torch.float32))
        return fm, rb, pen

    return node_candidates


def forced_record(rec: SplitRecord, at: torch.Tensor, ff, fb, sums,
                  params: SplitParams) -> SplitRecord:
    """rec with the forced split in the slots `at` marks: numerical at
    (ff, fb), missing values right, gain left + right - parent."""
    flg, flh, flc, fpg, fph, fpn = sums
    gain = (leaf_gain(flg, flh, params)
            + leaf_gain(fpg - flg, fph - flh, params)
            - leaf_gain(fpg, fph, params))

    def put(a, v):
        return torch.where(at, v.to(a.dtype), a)

    return SplitRecord(
        gain=put(rec.gain, gain), feature=put(rec.feature, ff),
        bin=put(rec.bin, fb), default_left=rec.default_left & ~at,
        is_cat=None if rec.is_cat is None else rec.is_cat & ~at,
        cat_mask=(None if rec.cat_mask is None
                  else rec.cat_mask & ~at[:, None]),
        left_g=put(rec.left_g, flg), left_h=put(rec.left_h, flh),
        left_c=put(rec.left_c, flc), right_g=put(rec.right_g, fpg - flg),
        right_h=put(rec.right_h, fph - flh),
        right_c=put(rec.right_c, fpn - flc),
    )


def split_leaf_outputs(rec: SplitRecord, params: SplitParams, parent_output,
                       cmin=None, cmax=None, num_bins=None,
                       cat_subset: bool = False):
    """Left/right child outputs of chosen splits: path smoothing toward
    the parent output, clamped to the parent's monotone interval.
    Under cat_subset, sorted-subset splits (categorical on a feature of
    more than max_cat_to_onehot bins) regularize with l2 + cat_l2
    (feature_histogram.cpp:251,346)."""
    p = params
    if cat_subset:
        is_sub = rec.is_cat & (num_bins[rec.feature.long()]
                               > params.max_cat_to_onehot)
        p = params._replace(lambda_l2=params.lambda_l2 + torch.where(
            is_sub, params.cat_l2, 0.0).to(torch.float32))
    lo = leaf_output(rec.left_g, rec.left_h, p, rec.left_c,
                     parent_output, cmin, cmax)
    ro = leaf_output(rec.right_g, rec.right_h, p, rec.right_c,
                     parent_output, cmin, cmax)
    return lo, ro


def monotone_child_intervals(feature, is_cat, mono, lo, ro, cur_min,
                             cur_max):
    """BasicLeafConstraints::Update (monotone_constraints.hpp:489): a
    numerical split on a monotone feature bounds the children at
    mid = (lo + ro) / 2; a categorical split never does."""
    m = mono[feature.long()]
    upd = m != 0
    if is_cat is not None:
        upd = upd & ~is_cat
    mid = (lo + ro) / 2.0
    lmin = torch.where(upd & (m < 0), torch.maximum(cur_min, mid), cur_min)
    lmax = torch.where(upd & (m > 0), torch.minimum(cur_max, mid), cur_max)
    rmin = torch.where(upd & (m > 0), torch.maximum(cur_min, mid), cur_min)
    rmax = torch.where(upd & (m < 0), torch.minimum(cur_max, mid), cur_max)
    return lmin, lmax, rmin, rmax


def mono_bounds(mode: int, anc_in, anc_left, leaf_out, node_feature,
                node_cat, mono, i_new, flo=None, fhi=None):
    """Every leaf's monotone [min, max] under the intermediate (mode 1)
    or advanced (mode 2) method, the JAX package's recompute
    (rounds.py:966-1099, permuted.py:866-905; monotone_constraints.hpp
    :516 GoUpToFindLeavesToUpdate, :858 AdvancedLeafConstraints): a leaf
    in the left subtree of a live increasing node a is bounded above by
    the least output of a's right subtree, one in its right subtree below
    by the greatest output of its left subtree (mirrored for a decreasing
    node); a categorical node bounds nothing. anc_in / anc_left (L, L-1)
    bool: node a is an ancestor of the leaf / the leaf is on its left
    side; leaf_out (L,) the leaves' outputs; node_feature / node_cat
    (L-1,) the tree's nodes; i_new the splits made (a 0-dim tensor):
    leaves 0..i_new and nodes 0..i_new-1 are live. Under the advanced
    method a leaf r bounds leaf x through node a only where their bin
    ranges (flo, fhi] ((L, F) int32) meet in every feature but a's split
    feature. Only max and min reduce, so the bounds are exact: the same
    on every device and loop. Returns (min, max), (L,) each."""
    L = leaf_out.shape[0]
    dev = leaf_out.device
    valid_leaf = torch.arange(L, device=dev) <= i_new
    nf = node_feature.long()
    node_m = mono[nf] * (~node_cat).to(mono.dtype)
    node_alive = torch.arange(L - 1, device=dev) < i_new
    in_l = anc_in & anc_left & valid_leaf[:, None]
    in_r = anc_in & ~anc_left & valid_leaf[:, None]
    if mode == 2:
        # ivf[x, r, f]: the ranges of leaves x and r meet in feature f;
        # ok_pair[x, r, a]: they meet everywhere but (perhaps) on node
        # a's split feature
        F = flo.shape[1]
        ivf = (torch.maximum(flo[:, None, :], flo[None, :, :])
               < torch.minimum(fhi[:, None, :], fhi[None, :, :]))
        n_bad = (~ivf).sum(dim=2)
        bad_fa = ~ivf.index_select(2, nf.clamp_max(F - 1))  # (L, L, L-1)
        ok_pair = (n_bad[:, :, None] - bad_fa.to(n_bad.dtype)) <= 0
        out3 = leaf_out[None, :, None]

        def ext(in_m, hi: bool):
            sel = in_m[None, :, :] & ok_pair
            if hi:
                return torch.where(sel, out3, -BIG).amax(dim=1)
            return torch.where(sel, out3, BIG).amin(dim=1)  # (L, L-1)
    else:
        out2 = leaf_out[:, None]

        def ext(in_m, hi: bool):
            if hi:
                return torch.where(in_m, out2, -BIG).amax(dim=0)[None]
            return torch.where(in_m, out2, BIG).amin(dim=0)[None]

    l_max, l_min = ext(in_l, True), ext(in_l, False)
    r_max, r_min = ext(in_r, True), ext(in_r, False)
    inc = (node_alive & (node_m > 0))[None, :]
    dec = (node_alive & (node_m < 0))[None, :]
    cmax = torch.where(in_l & inc, r_min, BIG)
    cmax = torch.where(in_r & dec, l_min, cmax)
    cmin = torch.where(in_r & inc, l_max, -BIG)
    cmin = torch.where(in_l & dec, r_max, cmin)
    return cmin.amax(dim=1), cmax.amin(dim=1)


def empty_tree(L: int, B: int, device) -> TreeArrays:
    zi = lambda n: torch.zeros(n, dtype=torch.int32, device=device)
    zf = lambda n: torch.zeros(n, dtype=torch.float32, device=device)
    zb = lambda n: torch.zeros(n, dtype=torch.bool, device=device)
    return TreeArrays(
        num_nodes=torch.zeros((), dtype=torch.int32, device=device),
        node_feature=zi(L - 1), node_bin=zi(L - 1), node_gain=zf(L - 1),
        node_default_left=zb(L - 1), node_cat=zb(L - 1),
        node_cat_mask=torch.zeros((L - 1, B), dtype=torch.bool,
                                  device=device),
        node_left=zi(L - 1), node_right=zi(L - 1), node_value=zf(L - 1),
        node_weight=zf(L - 1), node_count=zf(L - 1),
        leaf_value=zf(L), leaf_weight=zf(L), leaf_count=zf(L),
        leaf_depth=zi(L),
    )


def select_global_rec(rec: SplitRecord, axis, lo: int) -> SplitRecord:
    """Every rank's best over its own column block (features from lo) ->
    the global winner of each leaf: one all-gather of the records, the
    max gain, ties to the lowest rank (parallel_tree_learner.h:209)."""
    rec = rec._replace(feature=rec.feature + lo)
    fields = [f for f in rec if f is not None]
    # one (fields, Bt[, B]) f64 tensor per rank: every field is exact in
    # f64 (f32 sums, int32 ids, bools)
    packed = torch.cat([f.to(torch.float64).reshape(f.shape[0], -1)
                        for f in fields], dim=1)  # (Bt, width)
    allr = axis.all_gather(packed)  # (n, Bt, width)
    w = torch.argmax(allr[:, :, 0], dim=0)  # first max: lowest rank
    pick = allr[w, torch.arange(allr.shape[1], device=allr.device)]
    out, j = [], 0
    for f in rec:
        if f is None:
            out.append(None)
            continue
        width = f[0].numel()
        out.append(pick[:, j:j + width].reshape(f.shape).to(f.dtype))
        j += width
    return SplitRecord(*out)


def grow_tree(bins_fm, nan_bin, num_bins, mono, is_cat, grad, hess, mask,
              feat_mask, params: SplitParams, spec: GrowerSpec,
              valid=None, bundle=None, gh_scale=None, loop=None,
              rng_key=None, group_mat=None, cegb=None, forced=None,
              deferred=None) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree -> (tree arrays, per-row leaf, -1 on padding rows).
    Dispatches as the JAX package's grow_tree does: the rounds grower
    when spec.rounds_slots > 0 (its round loop as `loop` says,
    device_loop.py), else the sequential permuted grower (f32 gradients
    only; gh_scale must then be None; its split and round loops as
    `loop` says). rng_key (the tree's node key: extra_trees,
    feature_fraction_bynode), group_mat ((NG, F) interaction groups),
    cegb (CegbInfo) and forced (ForcedSplits) feed the per-node extras
    and the forced phase that spec names. deferred: a 0-dim int64 device
    tensor to which the rounds grower adds the splits that monotone
    intermediate / advanced's conflict guard put off to a later round."""
    if spec.per_node and (spec.extra_trees or spec.ff_bynode) \
            and rng_key is None:
        raise ValueError("extra_trees / feature_fraction_bynode need rng_key")
    if spec.n_forced and forced is None:
        raise ValueError("spec.n_forced requires the forced= split plan")
    extras = dict(rng_key=rng_key, group_mat=group_mat, cegb=cegb,
                  forced=forced)
    if spec.rounds_slots > 0:
        from .rounds import grow_tree_rounds

        return grow_tree_rounds(bins_fm, nan_bin, num_bins, mono, is_cat,
                                grad, hess, mask, feat_mask, params, spec,
                                valid, bundle, gh_scale, loop,
                                deferred=deferred, **extras)
    if gh_scale is not None:
        raise ValueError("the permuted grower takes f32 gradients, not "
                         "integer levels with scales")
    from .permuted import grow_tree_permuted

    return grow_tree_permuted(bins_fm, nan_bin, num_bins, mono, is_cat, grad,
                              hess, mask, feat_mask, params, spec, valid,
                              bundle, loop=loop, **extras)


def add_score(score: torch.Tensor, row_leaf: torch.Tensor,
              leaf_value: torch.Tensor, shrinkage) -> torch.Tensor:
    """ScoreUpdater::AddScore via the partition vector (score_updater.hpp
    AddScore): the (N,) lookup from the (L,) leaf table is the take_small
    kernel on the card; rows with leaf -1 add 0."""
    from .histogram import take_cols

    return score + shrinkage * take_cols(leaf_value[None, :], row_leaf)[0]
