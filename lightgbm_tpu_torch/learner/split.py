"""Vectorized best-split search over (feature, threshold, missing direction).

The port of lightgbm_tpu/learner/split.py for numerical features, with a
leading batch axis written out (the JAX package vmaps one leaf at a
time): cumulative sums over the bin axis, the reference's gain formulas
(feature_histogram.hpp), and one masked argmax per leaf whose flat order
reproduces the reference's scan-order tie-break (split.py:17, :430).

Two details keep the port's numbers equal to the JAX package's on the
CPU:
- `cumsum_last` adds in XLA:CPU's order (blocks of 16 added in
  sequence, block totals prefixed the same way, recursively) instead of
  torch's, which accumulates in double on the CPU and in a parallel
  scan on the card. The order is fixed on both devices, so the card's
  result is also the same on every run.
- `first_argmax` returns the first maximum, or the first NaN when there
  is one, which is what jnp.argmax does.

Categorical splits (one-vs-rest and the sorted-subset scan) are not
ported (ROADMAP queue A) and the grower refuses datasets that have them.
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


class SplitRecord(NamedTuple):
    """Best split per leaf (reference split_info.hpp:22 SplitInfo); every
    field has the leaf batch as its leading axis."""

    gain: torch.Tensor  # f32, shifted; <= 0 means no valid split
    feature: torch.Tensor  # int32 used-feature index
    bin: torch.Tensor  # int32 threshold bin
    default_left: torch.Tensor  # bool
    left_g: torch.Tensor
    left_h: torch.Tensor
    left_c: torch.Tensor
    right_g: torch.Tensor
    right_h: torch.Tensor
    right_c: torch.Tensor


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


def best_split(*args, **kwargs) -> SplitRecord:
    """Best numerical split of each leaf in the batch (arguments as
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
    feat_mask: Optional[torch.Tensor] = None,  # (F,) bool
    parent_output: Optional[torch.Tensor] = None,  # (Bt,)
    cmin: Optional[torch.Tensor] = None,  # (Bt,) monotone interval
    cmax: Optional[torch.Tensor] = None,
    has_mono: bool = False,
):
    Bt, _, F, B = hist.shape
    dev = hist.device
    if parent_output is None:
        parent_output = torch.zeros(Bt, dtype=torch.float32, device=dev)
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
    t_ok = (bin_idx < last_real)[None]  # numerical features only
    ok_dr = ok_dr & t_ok
    ok_dl = ok_dl & t_ok

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
    # third direction: the categorical one-vs-rest slot, never valid for
    # numerical features; kept so the flat index order is the JAX one
    gain_cat = gain_dr
    ok_cat = torch.zeros_like(ok_dr)
    D = 3
    gains = torch.stack([gain_dl_s, gain_dr_s, gain_cat], dim=-1) - shift
    ok = torch.stack([ok_dl_s, ok_dr_s, ok_cat], dim=-1)  # (Bt, F, B, D)
    if feat_mask is not None:
        ok = ok & feat_mask[None, :, None, None]
    gains = torch.where(ok, gains, torch.full_like(gains, NEG_INF))

    flat = gains.reshape(Bt, -1)
    idx = first_argmax(flat, dim=1)  # (Bt,)
    best_gain = torch.gather(flat, 1, idx[:, None])[:, 0]
    f = idx // (B * D)
    b = (idx // D) % B
    d = idx % D
    default_left = d == 0
    lr_f = last_real[f, 0]
    was_flipped = (d == 0) | ((d == 1) & (nan_bin[f] < 0))
    b = torch.where(was_flipped, torch.clamp(lr_f - 1 - b, 0, B - 1), b)

    ar = torch.arange(Bt, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    lg = cg[ar, f, b] + torch.where(default_left, nan_g[ar, f, 0], zero)
    lh = ch[ar, f, b] + torch.where(default_left, nan_h[ar, f, 0], zero)
    lc = cc[ar, f, b] + torch.where(default_left, nan_c[ar, f, 0], zero)
    rec = SplitRecord(
        gain=best_gain,
        feature=f.to(torch.int32),
        bin=b.to(torch.int32),
        default_left=default_left,
        left_g=lg, left_h=lh, left_c=lc,
        right_g=sum_g - lg, right_h=sum_h - lh, right_c=sum_c - lc,
    )
    return rec, gains.reshape(Bt, F, B * D).amax(dim=2)
