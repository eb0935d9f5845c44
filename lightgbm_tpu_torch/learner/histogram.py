"""Feature histograms, the per-round fused pass, take and seg_sum.

Every entry point has the JAX package's signature and return layout
(lightgbm_tpu/learner/histogram.py): bins are feature-major (G, N)
int32 with rows on the long axis, histograms (S, 3, G, Bc) f32 with
channels (gradient, hessian, count).

The dispatch rule: a CUDA tensor goes to the hand-written kernel in
cuda_hist.py, a CPU tensor to the plain PyTorch version beside it here.
There is nothing else — no size gates, no fallback when a build or
launch fails. The plain versions are the CPU path of the tests and the
yardstick chip_smoke.py holds each kernel against on the card.

Only the integer (int16-level) mode exists: gradients arrive as
integer levels (quantize.discretize_gradients_int) in a (3, N) int32
tensor of (gradient level, hessian level, in-bag count). The
5-channel f32 mode and the int8 mode of the JAX package are not ported
(ROADMAP queue B) and raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .quantize import HIST_DTYPE_LEVELS

HIST_BLK = 2048  # device row padding is a multiple of this
INT16_LEVELS = HIST_DTYPE_LEVELS["int16"]


def build_gh8_quant(gq: torch.Tensor, hq: torch.Tensor,
                    count: torch.Tensor) -> torch.Tensor:
    """Integer-level channels (g_int, h_int, count) -> (3, N) int32 —
    the layout of the JAX package's build_gh8_quant without its five
    zero rows (the kernels here have no matrix-unit tile to fill)."""
    return torch.stack([gq, hq, count]).to(torch.int32)


def root_sums_quant(gh: torch.Tensor) -> torch.Tensor:
    """(3,) f32 sums of the integer channels over all rows (exact)."""
    return gh.to(torch.int64).sum(dim=1).to(torch.float32)


def _require_quant(quant: bool, int8: bool) -> None:
    if not quant:
        raise NotImplementedError(
            "the 5-channel f32 histogram mode (tpu_hist_dtype=bf16x2) of "
            "hist_nat/hist_round is not ported (ROADMAP queue B)"
        )
    if int8:
        raise NotImplementedError(
            "the int8 SWAR histogram mode (tpu_hist_dtype=int8) is not "
            "ported (ROADMAP queue B)"
        )


# ---------------------------------------------------------------- hist_nat
def hist_nat_slots_plain(bins_fm: torch.Tensor, gh: torch.Tensor,
                         slot: torch.Tensor, num_slots: int,
                         num_bins: int) -> torch.Tensor:
    """Plain version of hist_nat: one int64 index_add_ over the flat key
    (slot, channel, column, bin). Rows with slot outside [0, S) or a bin
    outside [0, Bc) land in a trash cell."""
    G, N = bins_fm.shape
    S, B = int(num_slots), int(num_bins)
    dev = bins_fm.device
    size = S * 3 * G * B
    s = slot.to(torch.int64)[None, :]
    b = bins_fm.to(torch.int64)
    ok = (s >= 0) & (s < S) & (b >= 0) & (b < B)  # (G, N)
    g = torch.arange(G, device=dev, dtype=torch.int64)[:, None]
    out = torch.zeros(size + 1, dtype=torch.int64, device=dev)
    for c in range(3):
        key = torch.where(ok, ((s * 3 + c) * G + g) * B + b, size)
        vals = gh[c].to(torch.int64)[None, :].expand(G, N)
        out.index_add_(0, key.reshape(-1), vals.reshape(-1))
    return out[:size].reshape(S, 3, G, B).to(torch.float32)


def hist_nat_slots(
    bins_fm: torch.Tensor,  # (G, N) int32, natural row order
    gh: torch.Tensor,  # (3, N) int32 integer levels (build_gh8_quant)
    slot: torch.Tensor,  # (N,) int32 in [0, num_slots]; num_slots = trash
    num_slots: int,
    num_bins: int,
    quant: bool = True,
    int8: bool = False,
    levels: int = INT16_LEVELS,
) -> torch.Tensor:
    """Per-slot histograms keyed by a row -> slot vector -> (S, 3, G, Bc)
    f32 exact integer sums (hist_nat kernel on the card)."""
    _require_quant(quant, int8)
    if bins_fm.is_cuda:
        from .cuda_hist import hist_nat

        return hist_nat(bins_fm, gh, slot, num_slots, num_bins, levels)
    return hist_nat_slots_plain(bins_fm, gh, slot, num_slots, num_bins)


# -------------------------------------------------------------- hist_round
def round_partition_plain(bins_fm: torch.Tensor, pleaf: torch.Tensor,
                          params: torch.Tensor, num_slots: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partition half of hist_round: (new row -> leaf, histogram slot
    per row in [0, S]). Same math as the JAX package's non-fused round
    (rounds.py:758-831) with per-row gathers in place of the packed
    matmul; the EFB decode reads the params' columns 7..9 as the fused
    TPU kernel does (pallas_hist.py:407-414)."""
    G, N = bins_fm.shape
    S = int(num_slots)
    dev = bins_fm.device
    sel = params[:, 0]  # (S,) leaf id, -1 = unused slot
    # per-row slot: memberships are disjoint, so a one-hot max is exact
    memb = pleaf[:, None] == sel[None, :]  # (N, S)
    in_split = memb.any(dim=1)
    slot_row = torch.argmax(memb.to(torch.int8), dim=1)  # 0 when not in
    p = params[slot_row]  # (N, 16)
    rows = torch.arange(N, device=dev)
    fb = bins_fm[p[:, 1].clamp(0, G - 1).long(), rows]
    lo, mfb, wid = p[:, 7], p[:, 8], p[:, 9]
    t = fb - lo
    in_r = (t >= 0) & (t < wid)
    dec = torch.where(in_r, t + (t >= mfb).to(t.dtype), mfb)
    fb = torch.where(mfb >= 0, dec, fb)
    go_left = (fb <= p[:, 2]) | ((p[:, 3] != 0) & (fb == p[:, 4])
                                 & (p[:, 4] >= 0))
    pleaf_new = torch.where(in_split & ~go_left, p[:, 6], pleaf)
    go_small = go_left == (p[:, 5] != 0)
    hslot = torch.where(in_split & go_small, slot_row.to(torch.int32),
                        torch.full_like(pleaf, S))
    return pleaf_new.to(torch.int32), hslot.to(torch.int32)


def hist_round_plain(bins_fm, gh, pleaf, params, num_slots, num_bins):
    pleaf_new, hslot = round_partition_plain(bins_fm, pleaf, params,
                                             num_slots)
    return (hist_nat_slots_plain(bins_fm, gh, hslot, num_slots, num_bins),
            pleaf_new)


def hist_round(
    bins_fm: torch.Tensor,  # (G, N) int32
    gh: torch.Tensor,  # (3, N) int32 integer levels
    pleaf: torch.Tensor,  # (N,) int32 row -> leaf, in [0, num_leaves]
    params: torch.Tensor,  # (S, 16) int32 per-slot split params
    num_slots: int,
    num_bins: int,
    num_leaves: int,
    quant: bool = True,
    int8: bool = False,
    cat_mask: Optional[torch.Tensor] = None,
    levels: int = INT16_LEVELS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused round -> ((S, 3, G, Bc) f32 smaller-child histograms,
    (N,) int32 new row -> leaf). params columns as csrc/hist_round.cu
    documents them; an unused slot has leaf id -1. Unlike the JAX
    package's version this takes no column one-hot: the kernel reads
    the split column directly."""
    _require_quant(quant, int8)
    if cat_mask is not None:
        raise NotImplementedError(
            "categorical splits in the fused round (the in-kernel category "
            "set test) are not ported (ROADMAP queue B)"
        )
    if bins_fm.is_cuda:
        from .cuda_hist import hist_round as _kernel

        return _kernel(bins_fm, gh, pleaf, params, num_slots, num_bins,
                       num_leaves, levels)
    return hist_round_plain(bins_fm, gh, pleaf, params, num_slots, num_bins)


# ------------------------------------------------------------ take / segsum
def take_cols_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    L = tab.shape[1]
    ok = (idx >= 0) & (idx < L)
    out = tab[:, idx.clamp(0, L - 1).long()]
    return torch.where(ok[None, :], out, torch.zeros((), dtype=tab.dtype,
                                                     device=tab.device))


def take_cols(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(k, L) f32 table, (N,) int32 indices -> (k, N) tab[:, idx]; indices
    outside [0, L) give 0 (take_small kernel on the card)."""
    if tab.is_cuda:
        from .cuda_hist import take_small

        return take_small(tab.contiguous(), idx.contiguous())
    return take_cols_plain(tab, idx)


def seg_sum_plain(vals: torch.Tensor, idx: torch.Tensor,
                  num_out: int) -> torch.Tensor:
    k, N = vals.shape
    ok = (idx >= 0) & (idx < num_out)
    safe = torch.where(ok, idx, num_out).long()
    out = torch.zeros((k, num_out + 1), dtype=vals.dtype, device=vals.device)
    out.index_add_(1, safe, torch.where(ok[None, :], vals, 0.0))
    return out[:, :num_out]


def seg_sum(vals: torch.Tensor, idx: torch.Tensor, num_out: int
            ) -> torch.Tensor:
    """(k, N) values + (N,) int32 indices -> (k, num_out) per-index sums;
    out-of-range indices are dropped (seg_sum kernel on the card, whose
    fixed-order reduction gives the same bits on every run)."""
    if vals.is_cuda:
        from .cuda_hist import seg_sum as _kernel

        return _kernel(vals.contiguous(), idx.contiguous(), num_out)
    return seg_sum_plain(vals, idx, num_out)
