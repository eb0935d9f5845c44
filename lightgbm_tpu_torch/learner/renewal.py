"""Percentile leaf refit for the renewing regression objectives.

The port of lightgbm_tpu/learner/renewal.py. The reference refits each
leaf's output to a weighted percentile of the residuals of its in-bag
rows (RegressionL1loss::RenewTreeOutput, regression_objective.hpp:251;
gbdt.cpp:418 RenewTreeOutput before shrinkage) — L1, Huber and MAPE at
the median, Quantile at alpha.

Like the JAX package it never sorts: it runs a fixed number of
histogram refinement passes. Each pass bins every row's residual into
256 bins of its leaf's current bracket (the bracket parameters per row
through take_cols, the take_small kernel on the card), sums the weights
per (leaf, bin) with hist_nat_slots in its f32 mode (one slot per leaf,
the hist_nat kernel's f32 mode on the card), and narrows each leaf's
bracket to the bin where the cumulative weight crosses alpha * total.
Four passes resolve the crossing element to 2^-32 of the residual range,
below f32 resolution: the "first element whose cumulative weight
reaches the target" convention (the reference's interpolation between
adjacent order statistics is not replicated; documented deviation of
the JAX package). The per-leaf totals are one seg_sum.

The cumulative weight adds in XLA:CPU's order (split.cumsum_last), so
the crossing bin is chosen from the same f32 numbers as in the JAX
package. The per-bin weight sums are fixed point here (exact, the same
bits on the card) and f32 blocks in the JAX package's XLA fallback;
where weights' sums round differently in f32 the two could cross at
different bins (ROADMAP C).
"""

from __future__ import annotations

import torch

from .histogram import build_gh3, hist_nat_slots, seg_sum, take_cols
from .split import cumsum_last

REFIT_PASSES = 4
REFIT_BINS = 256


def renew_leaf_values(leaf_value: torch.Tensor, row_leaf: torch.Tensor,
                      resid: torch.Tensor, w: torch.Tensor, alpha: float,
                      num_leaves: int, passes: int = REFIT_PASSES,
                      num_bins: int = REFIT_BINS, axis=None,
                      n_rows: int = 0) -> torch.Tensor:
    """Weighted alpha-percentile of each leaf's residuals -> (L,) f32.

    leaf_value: (L,) current outputs (kept where a leaf has no rows)
    row_leaf:   (N,) int32 leaf id per row; negative = not in any leaf
    resid:      (N,) f32 residuals (label - score)
    w:          (N,) f32 weights; 0 excludes a row (padding / out-of-bag)
    alpha:      percentile in [0, 1] (0.5 = median)
    axis:       a data-parallel run's mesh (n_rows its global padded
                rows): the range, totals and bin sums over every rank's
                rows (the bin sums cross the wire as f32)
    """
    L, B = int(num_leaves), int(num_bins)
    dev = resid.device
    f32 = torch.float32
    incl = (w > 0) & (row_leaf >= 0)
    key = torch.where(incl, row_leaf, L).to(torch.int32)
    wv = torch.where(incl, w, 0.0).to(f32)
    rv = resid.to(f32)
    inf = torch.full((), float("inf"), dtype=f32, device=dev)

    # the global residual range seeds every leaf's bracket
    rmin = torch.where(incl, rv, inf).min()
    rmax = torch.where(incl, rv, -inf).max()
    if axis is not None:
        ext = axis.all_reduce(torch.stack([-rmin, rmax]), "max")
        rmin, rmax = -ext[0], ext[1]
    zero = torch.zeros((), dtype=f32, device=dev)
    rmin = torch.where(torch.isfinite(rmin), rmin, zero)
    rmax = torch.where(torch.isfinite(rmax), rmax, zero)
    span = torch.clamp_min(rmax - rmin, 1e-20)
    lo = rmin.expand(L).clone()
    # exclusive upper edge: the max element must land in bin B - 1
    hi = (rmax + span * 1e-6).expand(L).clone()

    totals = seg_sum(wv[None, :], key, L, axis=axis, n_rows=n_rows)[0]
    target = alpha * totals
    base = torch.zeros(L, dtype=f32, device=dev)  # weight below lo
    zeros_n = torch.zeros_like(wv)
    for _ in range(passes):
        # a late pass can shrink a bracket below one ulp of lo (hi ==
        # lo); the clamp keeps inv_w finite, so the bracket stops moving
        inv_w = B / torch.clamp_min(hi - lo, 1e-30)
        pr = take_cols(torch.stack([lo, inv_w]), key)  # (2, N); 0 off-leaf
        # clamped before the cast: far-off rows are out of the bracket
        # either way, and f32 -> int32 is undefined beyond its range
        binp = torch.floor((rv - pr[0]) * pr[1]).clamp(-1, B).to(torch.int32)
        # rows outside the current bracket are already in `base` (below)
        # or above the target (beyond): drop them
        inb = (binp >= 0) & (binp < B) & incl
        slot = torch.where(inb, key, L).to(torch.int32)
        bins = torch.where(inb, binp, 0)[None, :]  # (1, N)
        gh = build_gh3(wv, zeros_n, inb.to(f32))
        h = hist_nat_slots(bins, gh, slot, L, B, quant=False)[:, 0, 0]
        if axis is not None:
            h = axis.all_reduce(h)
        cum = cumsum_last(h)  # (L, B) weight sums in XLA:CPU's order
        cb = base[:, None] + cum
        bstar = torch.clamp((cb < target[:, None]).sum(dim=1), 0, B - 1)
        below = torch.where(
            bstar > 0,
            torch.gather(cum, 1, (bstar - 1).clamp_min(0)[:, None])[:, 0],
            zero)
        width = (hi - lo) * (1.0 / B)
        base = base + below
        lo = lo + bstar.to(f32) * width
        hi = lo + width

    val = (lo + hi) * 0.5
    return torch.where(totals > 0, val, leaf_value)
