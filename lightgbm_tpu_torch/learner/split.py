"""Vectorized best-split search over (feature, threshold, direction).

The port of lightgbm_tpu/learner/split.py, with a leading batch axis
written out (the JAX package vmaps one leaf at a time): cumulative sums
over the bin axis, the reference's gain formulas (feature_histogram.hpp),
and one masked argmax per leaf whose flat order reproduces the
reference's scan-order tie-break (split.py:17, :430). The directions are
default-left, default-right, categorical one-vs-rest and, under
`cat_subset`, the ascending and descending prefixes of the sorted-subset
scan (_cat_subset_scan) — direction last in the flat order, as the JAX
package stacks them.

Two details keep the port's numbers equal to the JAX package's on the
CPU:
- `cumsum_last` adds in XLA:CPU's order (blocks of 16 added in
  sequence, block totals prefixed the same way, recursively) instead of
  torch's, which accumulates in double on the CPU and in a parallel
  scan on the card. The order is fixed on both devices, so the card's
  result is also the same on every run.
- `first_argmax` returns the first maximum, or the first NaN when there
  is one, which is what jnp.argmax does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NEG_INF = -1e30
K_EPSILON = 1e-15  # reference kEpsilon (meta.h)
BIG = 1e29  # constraint sentinel (comfortably inside f32)
_CUMSUM_BLOCK = 16


class SplitParams(NamedTuple):
    """Split hyper-parameters (host scalars)."""

    lambda_l1: float
    lambda_l2: float
    min_data_in_leaf: float
    min_sum_hessian_in_leaf: float
    min_gain_to_split: float
    max_delta_step: float
    path_smooth: float
    # categorical sorted-subset params (feature_histogram.hpp:449+)
    cat_smooth: float
    cat_l2: float
    max_cat_threshold: int
    max_cat_to_onehot: int
    min_data_per_group: float
    # CEGB (cost_effective_gradient_boosting.hpp:79 DeltaGain)
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    # per-node feature sampling rate (ColSampler feature_fraction_bynode)
    feature_fraction_bynode: float = 1.0


class SplitRecord(NamedTuple):
    """Best split per leaf (reference split_info.hpp:22 SplitInfo); every
    field has the leaf batch as its leading axis."""

    gain: torch.Tensor  # f32, shifted; <= 0 means no valid split
    feature: torch.Tensor  # int32 used-feature index
    bin: torch.Tensor  # int32 threshold bin
    default_left: torch.Tensor  # bool
    # None in the search of a dataset without categorical features
    is_cat: Optional[torch.Tensor]  # bool
    cat_mask: Optional[torch.Tensor]  # (Bt, B) bool: the bins going left
    left_g: torch.Tensor
    left_h: torch.Tensor
    left_c: torch.Tensor
    right_g: torch.Tensor
    right_h: torch.Tensor
    right_c: torch.Tensor


def map_record(fn, *recs: SplitRecord) -> SplitRecord:
    """fn over the records' fields, one field at a time; a field the
    first record leaves out (None) stays None."""
    return SplitRecord(*[None if fs[0] is None else fn(*fs)
                         for fs in zip(*recs)])


def _seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    cols = [x[..., 0]]
    for j in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., j])
    return torch.stack(cols, dim=-1)


def cumsum_last(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis in XLA:CPU's f32 order."""
    n = x.shape[-1]
    if n <= _CUMSUM_BLOCK:
        return _seq_cumsum(x)
    m = -(-n // _CUMSUM_BLOCK) * _CUMSUM_BLOCK
    xp = torch.nn.functional.pad(x, (0, m - n))
    loc = _seq_cumsum(xp.reshape(*x.shape[:-1], m // _CUMSUM_BLOCK,
                                 _CUMSUM_BLOCK))
    pre = cumsum_last(loc[..., -1])
    ex = torch.cat([torch.zeros_like(pre[..., :1]), pre[..., :-1]], dim=-1)
    return (loc + ex[..., None]).reshape(*x.shape[:-1], m)[..., :n]


def first_argmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """jnp.argmax semantics: the first NaN if any, else the first maximum."""
    nan = torch.isnan(x)
    idx_nan = torch.argmax(nan.to(torch.int8), dim=dim)
    idx = torch.argmax(torch.where(nan, torch.zeros_like(x), x), dim=dim)
    return torch.where(nan.any(dim=dim), idx_nan, idx)


def threshold_l1(s: torch.Tensor, l1: float) -> torch.Tensor:
    """reference feature_histogram.hpp ThresholdL1."""
    return torch.sign(s) * torch.clamp_min(torch.abs(s) - l1, 0.0)


def leaf_output(g, h, p: SplitParams, count=None, parent_output=None,
                cmin=None, cmax=None):
    """CalculateSplittedLeafOutput: -T(G)/(H+l2), clipped by
    max_delta_step, path-smoothed toward the parent, clamped to the
    monotone interval [cmin, cmax]."""
    out = -threshold_l1(g, p.lambda_l1) / (h + p.lambda_l2 + K_EPSILON)
    if p.max_delta_step > 0.0:
        out = torch.clamp(out, -p.max_delta_step, p.max_delta_step)
    if count is not None and parent_output is not None \
            and p.path_smooth > 0.0:
        denom = count + p.path_smooth
        out = (out * count + parent_output * p.path_smooth) / torch.clamp_min(
            denom, K_EPSILON)
    if cmin is not None:
        out = torch.minimum(torch.maximum(out, cmin), cmax)
    return out


def leaf_gain_given_output(g, h, p: SplitParams, output):
    """GetLeafGainGivenOutput: -(2 T(G) o + (H+l2) o^2)."""
    t = threshold_l1(g, p.lambda_l1)
    return -(2.0 * t * output + (h + p.lambda_l2) * output * output)


def leaf_gain(g, h, p: SplitParams, count=None, parent_output=None,
              cmin=None, cmax=None):
    """GetLeafGain: T(G)^2/(H+l2) when no output modifier is active, else
    the gain at the clipped / smoothed / clamped output."""
    t = threshold_l1(g, p.lambda_l1)
    free = t * t / (h + p.lambda_l2 + K_EPSILON)
    static_active = p.max_delta_step > 0.0 or (
        count is not None and parent_output is not None
        and p.path_smooth > 0.0)
    if not static_active and cmin is None:
        return free
    o = leaf_output(g, h, p, count, parent_output, cmin, cmax)
    given = leaf_gain_given_output(g, h, p, o)
    if static_active:
        return given
    active = (cmin > -BIG) | (cmax < BIG)
    return torch.where(active, given, free)


def _cat_subset_scan(g, h, c, num_bins, nan_bin, big, sum_g, sum_h, sum_c,
                     params: SplitParams, po, cmn, cmx):
    """Sorted-subset categorical search (the JAX package's
    _cat_subset_scan, feature_histogram.cpp:246+ non-onehot branch) over
    (Bt, F, B) histograms of the features in `big` (F,) bool:

    - valid bins: count >= cat_smooth, inside num_bins, not the NaN bin;
    - stable sort by g / (h + cat_smooth), invalid bins last (+inf);
    - direction 0 sums ascending prefixes, direction 1 descending ones
      (the reversed sort rolled so the last valid bin comes first), with
      cumsum_last's XLA:CPU order and K_EPSILON added to the hessian;
    - prefix i is a candidate when i < min(max_cat_threshold,
      (used + 1) // 2), the break conditions (right side too small,
      monotone in i) have not fired, and the min_data_per_group batching
      evaluates there (below).

    Returns gains, ok (Bt, F, B, 2), the left sums (3, Bt, F, B, 2),
    inv_rank (Bt, F, B), valid_bin (Bt, F, B) and used (Bt, F)."""
    Bt, F, B = g.shape
    dev = g.device
    bidx = torch.arange(B, device=dev)
    valid_bin = ((c >= params.cat_smooth) & big[None, :, None]
                 & (bidx[None, None, :] < num_bins[None, :, None])
                 & (bidx[None, None, :] != nan_bin[None, :, None]))
    ratio = torch.where(valid_bin, g / (h + params.cat_smooth),
                        torch.full_like(g, float("inf")))
    order = torch.argsort(ratio, dim=2, stable=True)
    inv_rank = torch.argsort(order, dim=2)
    used = valid_bin.sum(dim=2)  # (Bt, F) int64

    vf = torch.gather(valid_bin, 2, order)
    sorted_ = [torch.where(vf, torch.gather(a, 2, order), 0.0)
               for a in (g, h, c)]
    # descending prefixes start from the end of the valid region
    roll = (bidx[None, None, :] + (B - used)[:, :, None]) % B
    pairs = [torch.stack([a, torch.gather(a.flip(2), 2, roll)], dim=2)
             for a in sorted_]  # (Bt, F, 2, B)
    lg, lh, lc = (cumsum_last(a).transpose(2, 3) for a in pairs)
    lh = lh + K_EPSILON  # (Bt, F, B, 2)
    sc2 = pairs[2].transpose(2, 3)
    rg = sum_g[:, None, None, None] - lg
    rh = sum_h[:, None, None, None] - lh
    rc = sum_c[:, None, None, None] - lc

    i_idx = bidx[None, None, :, None]
    max_num_cat = torch.clamp_max((used + 1) // 2,
                                  params.max_cat_threshold)[:, :, None, None]
    pos_ok = (i_idx < max_num_cat) & (i_idx < used[:, :, None, None])
    skip = (lc < params.min_data_in_leaf) | (lh < params.min_sum_hessian_in_leaf)
    brk = ((rc < params.min_data_in_leaf) | (rc < params.min_data_per_group)
           | (rh < params.min_sum_hessian_in_leaf))
    brk = torch.cumsum(brk.to(torch.int32), dim=2) > 0
    # min_data_per_group batching: the JAX package's lax.scan over all B
    # bins, whose state (rows gathered since the last evaluation) flows
    # forward only. pos_ok admits no prefix at or past max_cat_threshold,
    # so the first min(B, max_cat_threshold) steps give every `ok` that
    # can be True: the rest of `do_eval` stays False.
    do_eval = torch.zeros_like(skip)
    grp = torch.zeros_like(sc2[:, :, 0])
    for i in range(min(B, int(params.max_cat_threshold))):
        grp = grp + sc2[:, :, i]
        ev = ~skip[:, :, i] & ~brk[:, :, i] & (grp >= params.min_data_per_group)
        grp = torch.where(ev, torch.zeros_like(grp), grp)
        do_eval[:, :, i] = ev

    cat_p = params._replace(lambda_l2=_f32_add(params.lambda_l2,
                                               params.cat_l2))
    gains = (leaf_gain(lg, lh, cat_p, lc, po, cmn, cmx)
             + leaf_gain(rg, rh, cat_p, rc, po, cmn, cmx))
    return (gains, do_eval & pos_ok, (lg, lh, lc), inv_rank, valid_bin,
            used)


def _f32_add(a: float, b: float) -> float:
    """a + b rounded to f32, as the JAX package adds its f32 params."""
    import numpy as np

    return float(np.float32(a) + np.float32(b))


def best_split(*args, **kwargs) -> SplitRecord:
    """Best split of each leaf in the batch (arguments as
    _best_split_impl)."""
    return _best_split_impl(*args, **kwargs)[0]


def feature_best_gains(*args, **kwargs) -> torch.Tensor:
    """(Bt, F) best shifted gain per feature: max over thresholds and
    directions — the local vote of the voting-parallel learner."""
    return _best_split_impl(*args, **kwargs)[1]


def _best_split_impl(
    hist: torch.Tensor,  # (Bt, 3, F, B) f32 — (grad, hess, count)
    sum_g: torch.Tensor,  # (Bt,)
    sum_h: torch.Tensor,
    sum_c: torch.Tensor,
    num_bins: torch.Tensor,  # (F,) int32
    nan_bin: torch.Tensor,  # (F,) int32, -1 if no NaN bin
    mono: torch.Tensor,  # (F,) int32 in {-1, 0, 1}
    params: SplitParams,
    feat_mask: Optional[torch.Tensor] = None,  # (F,) or per leaf (Bt, F)
    parent_output: Optional[torch.Tensor] = None,  # (Bt,)
    cmin: Optional[torch.Tensor] = None,  # (Bt,) monotone interval
    cmax: Optional[torch.Tensor] = None,
    has_mono: bool = False,
    is_cat: Optional[torch.Tensor] = None,  # (F,) bool; None: a dataset
    # without categorical features, whose search skips their directions
    cat_subset: bool = False,  # the dataset has categoricals wider than
    # max_cat_to_onehot: the sorted-subset directions are searched
    penalty: Optional[torch.Tensor] = None,  # (Bt, F) CEGB DeltaGain
    rand_bin: Optional[torch.Tensor] = None,  # (Bt, F) extra_trees: the
    # one numerical threshold each feature may split at in each leaf
):
    Bt, _, F, B = hist.shape
    dev = hist.device
    if parent_output is None:
        parent_output = torch.zeros(Bt, dtype=torch.float32, device=dev)
    has_cat = is_cat is not None
    g, h, c = hist[:, 0], hist[:, 1], hist[:, 2]  # (Bt, F, B)
    bin_idx = torch.arange(B, device=dev, dtype=torch.int64)[None, :]

    has_nan = (nan_bin >= 0)[:, None]  # (F, 1)
    nb_safe = torch.clamp_min(nan_bin, 0).long()

    def nan_of(a):  # (Bt, F, B) -> (Bt, F, 1)
        v = torch.gather(a, 2, nb_safe[None, :, None].expand(Bt, F, 1))
        return torch.where(has_nan[None], v, torch.zeros_like(v))

    nan_g, nan_h, nan_c = nan_of(g), nan_of(h), nan_of(c)
    cum = cumsum_last(hist)  # (Bt, 3, F, B)
    cg, ch, cc = cum[:, 0], cum[:, 1], cum[:, 2]

    sg, sh, sc = sum_g[:, None, None], sum_h[:, None, None], \
        sum_c[:, None, None]
    po = parent_output[:, None, None]
    cmn = None if cmin is None else cmin[:, None, None]
    cmx = None if cmax is None else cmax[:, None, None]
    m = mono[None, :, None]

    def eval_lr(lg, lh, lc):
        rg, rh, rc = sg - lg, sh - lh, sc - lc
        gains = (leaf_gain(lg, lh, params, lc, po, cmn, cmx)
                 + leaf_gain(rg, rh, params, rc, po, cmn, cmx))
        ok = ((lc >= params.min_data_in_leaf) & (rc >= params.min_data_in_leaf)
              & (lh >= params.min_sum_hessian_in_leaf)
              & (rh >= params.min_sum_hessian_in_leaf))
        if has_mono:  # monotone basic: candidate-level output ordering
            lo = leaf_output(lg, lh, params, lc, po, cmn, cmx)
            ro = leaf_output(rg, rh, params, rc, po, cmn, cmx)
            ok = ok & torch.where(m > 0, lo <= ro, True)
            ok = ok & torch.where(m < 0, lo >= ro, True)
        return gains, ok

    gain_dr, ok_dr = eval_lr(cg, ch, cc)
    gain_dl, ok_dl = eval_lr(cg + nan_g, ch + nan_h, cc + nan_c)
    ok_dl = ok_dl & has_nan[None]

    nbf = num_bins[:, None].long()
    last_real = torch.where(nan_bin[:, None] >= 0, nbf - 2, nbf - 1)  # (F,1)
    num_mask = bin_idx < last_real
    if has_cat:
        num_mask = num_mask & ~is_cat[:, None]
    ok_dr = ok_dr & num_mask[None]
    ok_dl = ok_dl & num_mask[None]
    if rand_bin is not None:
        # extra_trees: one random numerical threshold per feature and
        # leaf, in the original bin space (before the tie-break
        # reindexing below); the categorical directions keep their search
        rb_ok = bin_idx[None] == rand_bin[:, :, None]
        ok_dr = ok_dr & rb_ok
        ok_dl = ok_dl & rb_ok

    if has_cat:
        # categorical one-vs-rest: bin t alone goes left; under
        # cat_subset only for features with num_bin <= max_cat_to_onehot
        # (feature_histogram.cpp:182 use_onehot)
        gain_cat, ok_cat = eval_lr(g, h, c)
        cat_ok = (is_cat[:, None] & (bin_idx < num_bins[:, None])
                  & (bin_idx != nan_bin[:, None]))
        if cat_subset:
            cat_ok = cat_ok & (num_bins <= params.max_cat_to_onehot)[:, None]
        ok_cat = ok_cat & cat_ok[None]
    else:
        # never valid; kept so the flat index order is the JAX one
        gain_cat, ok_cat = gain_dr, torch.zeros_like(ok_dr)

    parent_gain = leaf_gain(sum_g, sum_h, params)
    if params.path_smooth > 0.0:
        parent_gain = leaf_gain_given_output(sum_g, sum_h, params,
                                             parent_output)
    shift = (parent_gain + params.min_gain_to_split)[:, None, None, None]

    # tie-break order of the reference scan (split.py:379-407): the
    # default-left direction stored bin-flipped and first, the
    # default-right direction bin-flipped for features without a NaN bin
    bin_rev = torch.clamp(last_real - 1 - bin_idx, 0, B - 1)  # (F, B)
    rev = bin_rev[None].expand(Bt, F, B)

    def flipb(a):
        return torch.gather(a, 2, rev)

    no_nan = ~has_nan[None]
    gain_dl_s, ok_dl_s = flipb(gain_dl), flipb(ok_dl)
    gain_dr_s = torch.where(no_nan, flipb(gain_dr), gain_dr)
    ok_dr_s = torch.where(no_nan, flipb(ok_dr), ok_dr)
    dirs = [gain_dl_s, gain_dr_s, gain_cat]
    oks = [ok_dl_s, ok_dr_s, ok_cat]
    if has_cat and cat_subset:
        big = is_cat & (num_bins > params.max_cat_to_onehot)
        e4 = lambda a: None if a is None else a[..., None]
        cs_gain, cs_ok, cs_sums, inv_rank, valid_bin, cs_used = \
            _cat_subset_scan(g, h, c, num_bins, nan_bin, big, sum_g, sum_h,
                             sum_c, params, e4(po), e4(cmn), e4(cmx))
        dirs += [cs_gain[..., 0], cs_gain[..., 1]]
        oks += [cs_ok[..., 0], cs_ok[..., 1]]
    D = len(dirs)
    gains = torch.stack(dirs, dim=-1) - shift
    ok = torch.stack(oks, dim=-1)  # (Bt, F, B, D)
    if feat_mask is not None:
        fm = feat_mask if feat_mask.dim() == 2 else feat_mask[None]
        ok = ok & fm[:, :, None, None]
    gains = torch.where(ok, gains, torch.full_like(gains, NEG_INF))
    if penalty is not None:
        # CEGB DeltaGain: each feature's acquisition cost comes off every
        # candidate of that feature, the masked ones included
        gains = gains - penalty[:, :, None, None]

    flat = gains.reshape(Bt, -1)
    idx = first_argmax(flat, dim=1)  # (Bt,)
    best_gain = torch.gather(flat, 1, idx[:, None])[:, 0]
    f = idx // (B * D)
    b = (idx // D) % B
    d = idx % D
    default_left = d == 0
    lr_f = last_real[f, 0]
    was_flipped = (d == 0) | ((d == 1) & (nan_bin[f] < 0))
    cat = cat_mask = None
    if has_cat:
        cat = d >= 2
        was_flipped = was_flipped & ~cat
    b = torch.where(was_flipped, torch.clamp(lr_f - 1 - b, 0, B - 1), b)

    ar = torch.arange(Bt, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    lg = cg[ar, f, b] + torch.where(default_left, nan_g[ar, f, 0], zero)
    lh = ch[ar, f, b] + torch.where(default_left, nan_h[ar, f, 0], zero)
    lc = cc[ar, f, b] + torch.where(default_left, nan_c[ar, f, 0], zero)
    if has_cat:
        lg = torch.where(cat, g[ar, f, b], lg)
        lh = torch.where(cat, h[ar, f, b], lh)
        lc = torch.where(cat, c[ar, f, b], lc)
        # one-vs-rest left set: the winning bin
        cat_mask = (bin_idx == b[:, None]) & cat[:, None]  # (Bt, B)
    if has_cat and cat_subset:
        is_sub = d >= 3
        dd = (d - 3).clamp_min(0)
        lg = torch.where(is_sub, cs_sums[0][ar, f, b, dd], lg)
        lh = torch.where(is_sub, cs_sums[1][ar, f, b, dd], lh)
        lc = torch.where(is_sub, cs_sums[2][ar, f, b, dd], lc)
        rank_f = inv_rank[ar, f]  # (Bt, B)
        sub_mask = torch.where(
            (d == 3)[:, None], rank_f <= b[:, None],
            rank_f >= (cs_used[ar, f] - 1 - b)[:, None]) & valid_bin[ar, f]
        cat_mask = torch.where(is_sub[:, None], sub_mask, cat_mask)
    rec = SplitRecord(
        gain=best_gain,
        feature=f.to(torch.int32),
        bin=b.to(torch.int32),
        default_left=default_left,
        is_cat=cat,
        cat_mask=cat_mask,
        left_g=lg, left_h=lh, left_c=lc,
        right_g=sum_g - lg, right_h=sum_h - lh, right_c=sum_c - lc,
    )
    return rec, gains.reshape(Bt, F, B * D).amax(dim=2)
