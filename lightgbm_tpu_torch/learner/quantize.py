"""Integer gradient levels for the histograms, and true-gradient renewal.

The port of lightgbm_tpu/learner/quantize.py: the histogram channel
policy of every path (resolve_hist_dtype), and the integer levels of
the default path and of use_quantized_grad. Per tree, gradients and
hessians are discretized to integer levels with stochastic rounding
(reference gradient_discretizer.cpp:22), the grower accumulates exact
integer histograms and recovers f32 sums with the per-tree scales, and
afterwards leaf outputs are renewed from the TRUE gradients
(RenewIntGradTreeOutput): always on the default path, under
use_quantized_grad when quant_train_renew_leaf asks for it. The random
draws reproduce the JAX package's bit for bit (rng.py), so both
packages land on the same levels.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import rng

# internal discretization levels per channel layout: int16 carries 256
# levels (g in [-128, 128], h in [0, 256]), int8 carries 127 so that
# every level fits an int8 channel (g in [-63, 63], h in [0, 127])
HIST_DTYPE_LEVELS = {"int16": 256, "int8": 127}


def resolve_hist_dtype(requested: str, use_quantized_grad: bool,
                       num_grad_quant_bins: int,
                       use_rounds: bool = True) -> Tuple[str, int]:
    """tpu_hist_dtype -> (resolved channel layout, internal levels; 0 for
    the f32 layout and under use_quantized_grad), as the JAX package's
    resolve_hist_dtype.

    Under use_quantized_grad the public levels (num_grad_quant_bins)
    govern and the name reports what that path does: int8 channels on
    the rounds path at <= 127 levels (the default 4 levels), int16 at
    <= 256, the dequantized f32 layout above that and off the rounds
    path. Otherwise, on the rounds path `auto` means int16 on every
    device, as tpu_growth_mode=auto means the rounds grower on every
    device: the port has no CPU-only exact path for `auto` to stay
    bit-exact with. Explicit int16 / int8 take the internal int-packed
    path at 256 / 127 levels; bf16x2 (alias float32) is the f32 layout.
    Off the rounds path (tpu_growth_mode=exact) the channels are always
    f32: an explicit int request falls back with a warning."""
    if use_quantized_grad:
        if use_rounds and num_grad_quant_bins <= 127:
            return "int8", 0
        if use_rounds and num_grad_quant_bins <= 256:
            return "int16", 0
        return "bf16x2", 0
    req = "bf16x2" if requested == "float32" else requested
    if req == "auto":
        req = "int16" if use_rounds else "bf16x2"
    if req == "bf16x2":
        return req, 0
    if not use_rounds:
        from .. import log

        log.warning(
            f"tpu_hist_dtype={requested} needs the rounds growth path "
            "(tpu_growth_mode=rounds); falling back to bf16x2 channels"
        )
        return "bf16x2", 0
    return req, HIST_DTYPE_LEVELS[req]


def discretize_gradients_int(grad: torch.Tensor, hess: torch.Tensor,
                             key: torch.Tensor, num_bins: int,
                             stochastic: bool, absmax=None,
                             offset: int = 0):
    """(grad, hess) -> (grad levels, hess levels, (2,) scales): gradient
    levels in [-bins/2, bins/2], hessian levels in [0, bins]; stochastic
    rounding truncates toward zero after adding signed uniform noise.
    A data-parallel rank passes absmax, the (2,) max |grad|, |hess| over
    every rank's rows, and offset, its first row's place in the global
    row stream, whose draws it takes: the levels are then the ones one
    device holding every row computes for these rows."""
    gmax, hmax = ((grad.abs().max(), hess.abs().max()) if absmax is None
                  else (absmax[0], absmax[1]))
    g_scale = torch.clamp_min(gmax, 1e-30) / (num_bins // 2)
    h_scale = torch.clamp_min(hmax, 1e-30) / num_bins
    if stochastic:
        keys = rng.split(key)
        ug = rng.uniform(keys[0], grad.shape, offset)
        uh = rng.uniform(keys[1], hess.shape, offset)
    else:
        ug = uh = 0.5
    gq = torch.trunc(grad / g_scale + torch.sign(grad) * ug)
    hq = torch.trunc(hess / h_scale + uh)
    return gq, hq, torch.stack([g_scale, h_scale])


def renew_leaf_with_true_gradients(leaf_value, row_leaf, grad, hess, mask,
                                   params, num_leaves: int, axis=None,
                                   n_rows: int = 0):
    """quant_train_renew_leaf: leaf outputs from the TRUE per-leaf sums
    (seg_sum kernel on the card); axis / n_rows: a data-parallel run's
    mesh and global padded rows, summing every rank's rows (seg_sum)."""
    from .histogram import seg_sum
    from .split import leaf_output

    L = num_leaves
    idx = torch.where((row_leaf >= 0) & (mask > 0), row_leaf,
                      torch.full_like(row_leaf, L)).to(torch.int32)
    sums = seg_sum(torch.stack([grad * mask, hess * mask]), idx, L,
                   axis=axis, n_rows=n_rows)
    renewed = leaf_output(sums[0], sums[1], params)
    return torch.where(sums[1] > 0, renewed, leaf_value)
