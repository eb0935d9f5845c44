"""Tree arrays, growth spec and the per-tree helpers shared by the grower.

The port of lightgbm_tpu/learner/grower.py: the fixed-size tree layout
of the reference (include/LightGBM/tree.h; child pointers >= 0 are
internal nodes, < 0 leaves as ~leaf), the leaf output math of a chosen
split, the basic monotone intervals, the score update through the
row -> leaf vector, and grow_tree's dispatch between the rounds grower
(rounds.py) and the sequential permuted grower (permuted.py). The JAX
package's flat grower is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .split import SplitParams, SplitRecord, leaf_output


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
    has_mono: bool = False  # any monotone constraint (basic method)
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


def grow_tree(bins_fm, nan_bin, num_bins, mono, is_cat, grad, hess, mask,
              feat_mask, params: SplitParams, spec: GrowerSpec,
              valid=None, bundle=None, gh_scale=None, loop=None
              ) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree -> (tree arrays, per-row leaf, -1 on padding rows).
    Dispatches as the JAX package's grow_tree does: the rounds grower
    when spec.rounds_slots > 0 (its round loop as `loop` says,
    device_loop.py), else the sequential permuted grower (f32 gradients
    only; gh_scale must then be None; it reads the card once per split
    and takes no loop)."""
    if spec.rounds_slots > 0:
        from .rounds import grow_tree_rounds

        return grow_tree_rounds(bins_fm, nan_bin, num_bins, mono, is_cat,
                                grad, hess, mask, feat_mask, params, spec,
                                valid, bundle, gh_scale, loop)
    if loop is not None and loop.bounded:
        raise ValueError("the permuted grower runs on the eager loop only")
    if gh_scale is not None:
        raise ValueError("the permuted grower takes f32 gradients, not "
                         "integer levels with scales")
    from .permuted import grow_tree_permuted

    return grow_tree_permuted(bins_fm, nan_bin, num_bins, mono, is_cat, grad,
                              hess, mask, feat_mask, params, spec, valid,
                              bundle)


def add_score(score: torch.Tensor, row_leaf: torch.Tensor,
              leaf_value: torch.Tensor, shrinkage) -> torch.Tensor:
    """ScoreUpdater::AddScore via the partition vector (score_updater.hpp
    AddScore): the (N,) lookup from the (L,) leaf table is the take_small
    kernel on the card; rows with leaf -1 add 0."""
    from .histogram import take_cols

    return score + shrinkage * take_cols(leaf_value[None, :], row_leaf)[0]
