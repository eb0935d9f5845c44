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

Two channel layouts, both (3, N) with rows (gradient, hessian, count):
- integer levels (quantize.discretize_gradients_int), summed exactly in
  integers: hist_nat_slots and hist_round with quant=True. The channels
  are int8 when every level fits +-127 (use_quantized_grad's default 4
  levels, tpu_hist_dtype=int8), int32 otherwise (int16's 256 levels);
  the dtype picks the kernel mode and the sums are the same;
- f32 values (build_gh3), summed as int64 fixed point: histogram,
  hist_slots, and hist_nat_slots and hist_round with quant=False. The
  JAX package splits each f32 value into bf16 hi/lo halves only to feed
  the TPU's bf16 matrix unit and re-adds them in every consumer; since
  hi + lo == x exactly, the port carries the f32 value itself
  (ROADMAP C).

Fixed point (fx_*): each channel of a call is scaled by 2^k, rounded
to int64 and summed, then scaled back to f32. k = 62 - ceil(log2 n) -
e, where max |value| < 2^e over the call's rows and n bounds the rows
summed, so no cell sum reaches 2^62 and integer adds never overflow.
The sum is exact and independent of order — the kernels add with
integer atomics and still give the same bits on every run and the
same bits as these plain versions. Each value is rounded to
2^(e - 62 + ceil(log2 n)): 2^-42 of the channel's max at n = 2^20 rows,
far below f32's 2^-24, so the f32 result is the true sum to within f32
rounding unless n nears 2^38.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import cuda_hist
from .quantize import HIST_DTYPE_LEVELS

HIST_BLK = 2048  # device row padding is a multiple of this
INT16_LEVELS = HIST_DTYPE_LEVELS["int16"]


INT8_MAX = 127


def build_gh8_quant(gq: torch.Tensor, hq: torch.Tensor,
                    count: torch.Tensor, int8_levels: int = 0
                    ) -> torch.Tensor:
    """Integer-level channels (g_int, h_int, count) -> (3, N) — the
    layout of the JAX package's build_gh8_quant without its five zero
    rows (the kernels here have no matrix-unit tile to fill). int8_levels
    is the level count of a tree in the int8 mode (0: int32 channels).
    Stochastic rounding keeps every level within +-(levels + 1), so up
    to 126 levels the channels are int8 with no check; at 127 a hessian
    level can reach 128, and one host read decides (int32 if it does)."""
    gh = torch.stack([gq, hq, count])
    if int8_levels and (int8_levels < INT8_MAX
                        or bool(gh.abs().max() <= INT8_MAX)):
        return gh.to(torch.int8)
    return gh.to(torch.int32)


def root_sums_quant(gh: torch.Tensor, axis=None) -> torch.Tensor:
    """(3,) f32 sums of the integer channels over all rows (exact); axis
    (a parallel.comm.Mesh) sums every rank's rows, in int64."""
    s = gh.to(torch.int64).sum(dim=1)
    if axis is not None:
        s = axis.all_reduce(s)
    return s.to(torch.float32)


def build_gh3(grad: torch.Tensor, hess: torch.Tensor,
              count: torch.Tensor) -> torch.Tensor:
    """f32 channels (gradient, hessian, count), already masked -> (3, N)
    f32: the JAX package's build_gh8 with each hi/lo pair re-added."""
    return torch.stack([grad, hess, count]).to(torch.float32)


def root_sums(gh: torch.Tensor, axis=None) -> torch.Tensor:
    """(3,) f32 (sum_grad, sum_hess, count) over all rows of (3, N) f32
    channels: summed in f64 and rounded once. axis (a parallel.comm.Mesh)
    reduces the f64 sums over every rank's rows before the rounding
    (data_parallel_tree_learner.cpp:169-221, the root allreduce)."""
    s = gh.to(torch.float64).sum(dim=1)
    if axis is not None:
        s = axis.all_reduce(s)
    return s.to(torch.float32)


# --------------------------------------------------- sharded (mesh) wires
def rs_exact_ok(local_rows: int, n_ranks: int, quant_levels: int) -> bool:
    """Whether the integer reduce-scatter wire is exact for this shape
    (lightgbm_tpu/learner/histogram.py rs_exact_ok): the global
    hessian-channel worst case local_rows * n_ranks * levels under 2^31
    and each rank's sums within f32's exact integers (2^24)."""
    return rs_wire_dtype(local_rows, n_ranks, quant_levels) is not None


def rs_wire_dtype(local_rows: int, n_ranks: int,
                  quant_levels: int) -> "str | None":
    """The JAX package's narrowest exact wire dtype for the quantized
    histogram collectives: "int16" while the global worst case stays
    under 2^15, "int32" under 2^31 (with per-rank sums under 2^24), None
    past that (the f32 wire). Neither gloo nor NCCL reduces int16, so
    the port's collectives carry an "int16" wire as int32
    (parallel.comm.wire_dtype); the bytes it reports are int32's."""
    levels = max(int(quant_levels), 1)
    if local_rows * n_ranks * levels < 2 ** 15:
        return "int16"
    if (local_rows * n_ranks * levels < 2 ** 31
            and local_rows * levels < 2 ** 24):
        return "int32"
    return None


def int_wire(h: torch.Tensor, wire: "str | None") -> torch.Tensor:
    """f32 integer sums -> the wire's integer dtype (f32 kept for None)."""
    if wire is None:
        return h
    return h.to(torch.int16 if wire == "int16" else torch.int32)


def fx_axis_absmax(gh: torch.Tensor, axis, inside=None) -> torch.Tensor:
    """(3,) f32 channel maxima |value| over every rank's rows (or the
    rows `inside` marks): the fixed-point scale of a sharded call, which
    must be the one a single device holding all rows would take."""
    a = gh.abs()
    if inside is not None:
        a = torch.where(inside[None, :], a, torch.zeros_like(a))
    m = (a.amax(dim=1) if gh.shape[1] else
         torch.zeros(gh.shape[0], dtype=torch.float32, device=gh.device))
    return axis.all_reduce(m.to(torch.float32), "max")


def fx_axis_reduce(acc: torch.Tensor, absmax: torch.Tensor, n_rows: int,
                   axis) -> torch.Tensor:
    """A sharded call's int64 fixed-point partials (..., 3, G, B) or
    (k, L), summed over the axis and converted to f32 with the scale of
    (absmax, n_rows): the bits one device summing every row gives."""
    k = fx_exponents(absmax, n_rows)
    tot = axis.all_reduce(acc)
    if tot.dim() == 2:  # seg_sum's (k, L)
        return (tot.to(torch.float64) * _pow2(-k)[:, None]).to(
            torch.float32)
    return fx_to_f32(tot, k)


# ------------------------------------------------------------ fixed point
FX_BITS = 62


def fx_log2_rows(n_rows: int) -> int:
    """ceil(log2 n_rows): the headroom bits a sum of n_rows values needs."""
    return max(int(n_rows) - 1, 0).bit_length()


def fx_exponents(absmax: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(3,) f32 per-channel max |value| -> (3,) int32 scale exponents k
    (module docstring; csrc/hist_common.cuh fx_exponent)."""
    _, e = torch.frexp(absmax.to(torch.float32))
    return (FX_BITS - fx_log2_rows(n_rows) - e).to(torch.int32)


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """Exact f64 2^k from its bit pattern. Here |k| <= 210 (f32 maxima
    have 2^-148 <= 2^e <= 2^128), far inside f64's normal range."""
    return ((k.to(torch.int64) + 1023) << 52).view(torch.float64)


def fx_quantize(gh: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(3, n) f32 -> (3, n) int64 round-half-even(value * 2^k)."""
    return torch.round(gh.to(torch.float64) * _pow2(k)[:, None]
                       ).to(torch.int64)


def fx_to_f32(acc: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(..., 3, G, B) int64 fixed-point sums -> f32 (value * 2^-k)."""
    return (acc.to(torch.float64) * _pow2(-k)[:, None, None]
            ).to(torch.float32)


def _absmax(gh: torch.Tensor) -> torch.Tensor:
    if gh.shape[1] == 0:
        return torch.zeros(3, dtype=torch.float32, device=gh.device)
    return gh.abs().amax(dim=1)


# ---------------------------------------------------------------- hist_nat
def _slot_hist_int64(bins_fm: torch.Tensor, vals: torch.Tensor,
                     slot: torch.Tensor, num_slots: int,
                     num_bins: int) -> torch.Tensor:
    """(S, 3, G, Bc) int64 sums of (3, N) integer values: one int64
    index_add_ over the flat key (slot, channel, column, bin). Rows with
    slot outside [0, S) or a bin outside [0, Bc) land in a trash cell."""
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
        v = vals[c].to(torch.int64)[None, :].expand(G, N)
        out.index_add_(0, key.reshape(-1), v.reshape(-1))
    return out[:size].reshape(S, 3, G, B)


def hist_nat_slots_plain(bins_fm: torch.Tensor, gh: torch.Tensor,
                         slot: torch.Tensor, num_slots: int,
                         num_bins: int, quant: bool = True) -> torch.Tensor:
    """Plain version of hist_nat: exact integer sums of int8 / int32
    levels (quant), or fixed-point sums of f32 channels, the scale taken
    over all N rows."""
    if quant:
        return _slot_hist_int64(bins_fm, gh, slot, num_slots,
                                num_bins).to(torch.float32)
    k = fx_exponents(_absmax(gh), bins_fm.shape[1])
    acc = _slot_hist_int64(bins_fm, fx_quantize(gh, k), slot, num_slots,
                           num_bins)
    return fx_to_f32(acc, k)


def hist_nat_slots(
    bins_fm: torch.Tensor,  # (G, N) int32, natural row order
    gh: torch.Tensor,  # (3, N) int8 / int32 levels (quant) or f32 values
    slot: torch.Tensor,  # (N,) int32 in [0, num_slots]; num_slots = trash
    num_slots: int,
    num_bins: int,
    quant: bool = True,
    levels: int = INT16_LEVELS,
) -> torch.Tensor:
    """Per-slot histograms keyed by a row -> slot vector -> (S, 3, G, Bc)
    f32: exact integer sums of build_gh8_quant's levels (quant, `levels`
    bounds them), or fixed-point sums of build_gh3's f32 channels
    (quant=False: the percentile leaf refit's histograms). The hist_nat
    kernel on the card, in the mode of gh's dtype."""
    if bins_fm.is_cuda:
        if not quant:
            return cuda_hist.hist_nat_f32(bins_fm, gh, slot, num_slots,
                                          num_bins)
        return cuda_hist.hist_nat(bins_fm, gh, slot, num_slots, num_bins,
                                  levels)
    return hist_nat_slots_plain(bins_fm, gh, slot, num_slots, num_bins,
                                quant)


# ---------------------------------------------------------- f32 histogram
def _segment(begin, count, n_total: int) -> Tuple[int, int]:
    b = int(begin)
    c = n_total - b if count is None else int(count)
    return b, c


def histogram_plain(bins_fm: torch.Tensor, gh: torch.Tensor, num_bins: int,
                    begin=0, count=None, cap: Optional[int] = None, fx=None
                    ) -> torch.Tensor:
    """Plain version of hist: fixed-point sums over rows [begin,
    begin + count). Tensor bounds are never read on the host: the rows
    inside them are a mask over all N rows (the same sums). fx: a sharded
    call's ((3,) maxima over every rank, the scale's n): the scale comes
    from them and the int64 sums are returned."""
    G, N = bins_fm.shape
    if isinstance(begin, torch.Tensor) or isinstance(count, torch.Tensor):
        if cap is None:
            raise ValueError("tensor bounds need a host cap")
        dev = bins_fm.device
        pos = torch.arange(N, device=dev)
        b = torch.as_tensor(begin, device=dev).reshape(-1)[:1]
        e = N if count is None else \
            b + torch.as_tensor(count, device=dev).reshape(-1)[:1]
        inside = (pos >= b) & (pos < e)
        vals = torch.where(inside[None, :], gh, torch.zeros_like(gh))
        k = (fx_exponents(_absmax(vals), int(cap)) if fx is None
             else fx_exponents(*fx))
        acc = _slot_hist_int64(bins_fm, fx_quantize(vals, k),
                               (~inside).to(torch.int64), 1, num_bins)[0]
        return acc if fx is not None else fx_to_f32(acc, k)
    b, c = _segment(begin, count, N)
    cap = c if cap is None else int(cap)
    rows = slice(b, b + c)
    k = (fx_exponents(_absmax(gh[:, rows]), cap) if fx is None
         else fx_exponents(*fx))
    q = fx_quantize(gh[:, rows], k)
    zero = torch.zeros(c, dtype=torch.int64, device=bins_fm.device)
    acc = _slot_hist_int64(bins_fm[:, rows], q, zero, 1, num_bins)[0]
    return acc if fx is not None else fx_to_f32(acc, k)


def histogram(
    bins_fm: torch.Tensor,  # (G, N) int32
    gh: torch.Tensor,  # (3, N) f32 (build_gh3)
    num_bins: int,
    begin=0,
    count=None,
    cap: Optional[int] = None,
    fx=None,
) -> torch.Tensor:
    """One f32 histogram -> (3, G, Bc) over rows [begin, begin + count)
    (all rows by default) — the hist kernel on the card. begin and count
    may be 0-dim tensors on the bins' device, so a caller learns a
    segment's bounds without reading them back; `cap` (a host int) then
    bounds count and sizes the launch. The fixed-point scale takes n =
    cap (module docstring). fx: a sharded call's ((3,) channel maxima
    over every rank, the scale's n): the scale a device holding every
    row would take, and the (3, G, Bc) int64 sums to reduce
    (fx_axis_reduce)."""
    if bins_fm.is_cuda:
        return cuda_hist.hist(bins_fm, gh, num_bins, begin, count, cap, fx)
    return histogram_plain(bins_fm, gh, num_bins, begin, count, cap, fx)


def segment_slots(begins: torch.Tensor, counts: torch.Tensor,
                  n_rows: int) -> torch.Tensor:
    """(S,) disjoint row segments -> (N,) int64 slot per row, S for rows
    in no segment."""
    S = begins.shape[0]
    dev = begins.device
    pos = torch.arange(n_rows, device=dev)
    nz = counts > 0
    b = torch.where(nz, begins.to(torch.int64), n_rows)
    order = torch.argsort(b, stable=True)
    j = torch.searchsorted(b[order].contiguous(), pos, right=True) - 1
    cand = order[j.clamp_min(0)]
    inside = ((j >= 0) & nz[cand]
              & (pos < begins.to(torch.int64)[cand]
                 + counts.to(torch.int64)[cand]))
    return torch.where(inside, cand, S)


def hist_slots_plain(bins_fm: torch.Tensor, gh: torch.Tensor,
                     begins: torch.Tensor, counts: torch.Tensor,
                     num_bins: int, num_slots: int, fx=None) -> torch.Tensor:
    """Plain version of hist_slots: fixed-point sums, the scale taken
    over all N rows (fx: as histogram_plain's)."""
    G, N = bins_fm.shape
    k = fx_exponents(_absmax(gh), N) if fx is None else fx_exponents(*fx)
    slot = segment_slots(begins, counts, N)
    acc = _slot_hist_int64(bins_fm, fx_quantize(gh, k), slot, num_slots,
                           num_bins)
    return acc if fx is not None else fx_to_f32(acc, k)


def hist_slots(
    bins_fm: torch.Tensor,  # (G, N) int32, rows grouped by leaf
    gh: torch.Tensor,  # (3, N) f32, same row order
    begins: torch.Tensor,  # (S,) int32 segment starts
    counts: torch.Tensor,  # (S,) int32 segment lengths (0 = empty slot)
    num_bins: int,
    num_slots: int,
    fx=None,
) -> torch.Tensor:
    """Per-slot f32 histograms over disjoint contiguous row segments ->
    (S, 3, G, Bc); empty slots are zero (hist_slots kernel on the card,
    one launch for all slots). fx: as histogram's (int64 sums)."""
    if bins_fm.is_cuda:
        return cuda_hist.hist_slots(bins_fm, gh, begins, counts, num_bins,
                                    num_slots, fx)
    return hist_slots_plain(bins_fm, gh, begins, counts, num_bins,
                            num_slots, fx)


# -------------------------------------------------------------- hist_round
def round_partition_plain(bins_fm: torch.Tensor, pleaf: torch.Tensor,
                          params: torch.Tensor, num_slots: int,
                          cat_mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partition half of hist_round: (new row -> leaf, histogram slot
    per row in [0, S]). Same math as the JAX package's non-fused round
    (rounds.py:758-831) with per-row gathers in place of the packed
    matmul; the EFB decode reads the params' columns 7..9 as the fused
    TPU kernel does (pallas_hist.py:407-414). A row of a categorical slot
    (params column 10) goes left iff its decoded bin is in the slot's
    category set, cat_mask (S, Bc) bool; the threshold and default-left
    tests do not apply to it (rounds.py:795-816)."""
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
    if cat_mask is not None:
        Bm = cat_mask.shape[1]
        in_b = (fb >= 0) & (fb < Bm)
        hit = cat_mask[slot_row, fb.clamp(0, Bm - 1).long()] & in_b
        go_left = torch.where(p[:, 10] != 0, hit, go_left)
    pleaf_new = torch.where(in_split & ~go_left, p[:, 6], pleaf)
    go_small = go_left == (p[:, 5] != 0)
    hslot = torch.where(in_split & go_small, slot_row.to(torch.int32),
                        torch.full_like(pleaf, S))
    return pleaf_new.to(torch.int32), hslot.to(torch.int32)


def hist_round_plain(bins_fm, gh, pleaf, params, num_slots, num_bins,
                     quant: bool = True, cat_mask=None):
    """Plain version of hist_round: exact integer sums (quant) or
    fixed-point sums of f32 channels, the scale taken over all N rows."""
    pleaf_new, hslot = round_partition_plain(bins_fm, pleaf, params,
                                             num_slots, cat_mask)
    return (hist_nat_slots_plain(bins_fm, gh, hslot, num_slots, num_bins,
                                 quant), pleaf_new)


def hist_round(
    bins_fm: torch.Tensor,  # (G, N) int32
    gh: torch.Tensor,  # (3, N) int8 / int32 levels (quant) or f32 values
    pleaf: torch.Tensor,  # (N,) int32 row -> leaf, in [0, num_leaves]
    params: torch.Tensor,  # (S, 16) int32 per-slot split params
    num_slots: int,
    num_bins: int,
    num_leaves: int,
    quant: bool = True,
    cat_mask: Optional[torch.Tensor] = None,
    levels: int = INT16_LEVELS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused round -> ((S, 3, G, Bc) f32 smaller-child histograms,
    (N,) int32 new row -> leaf). params columns as csrc/hist_round.cu
    documents them; an unused slot has leaf id -1. Unlike the JAX
    package's version this takes no column one-hot: the kernel reads
    the split column directly. The kernel mode follows gh's dtype: int8
    or int32 levels (quant), or f32 channels summed as fixed point
    (quant=False, module docstring). cat_mask, (S, Bc) bool, holds the
    category sets of the slots that params column 10 flags categorical
    (the kernel's categorical mode); None when the dataset has none."""
    if bins_fm.is_cuda:
        return cuda_hist.hist_round(bins_fm, gh, pleaf, params, num_slots,
                                    num_bins, num_leaves, levels, cat_mask)
    return hist_round_plain(bins_fm, gh, pleaf, params, num_slots, num_bins,
                            quant, cat_mask)


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
        return cuda_hist.take_small(
            tab if tab.is_contiguous() else tab.contiguous(),
            idx if idx.is_contiguous() else idx.contiguous())
    return take_cols_plain(tab, idx)


def take_rows_plain(tab_rows: torch.Tensor, idx: torch.Tensor,
                    k: int) -> torch.Tensor:
    L = tab_rows.shape[0]
    ok = (idx >= 0) & (idx < L)
    out = tab_rows[idx.clamp(0, L - 1).long(), :k]
    return torch.where(ok[:, None], out, torch.zeros(
        (), dtype=tab_rows.dtype, device=tab_rows.device)).T.contiguous()


def take_rows(tab_rows: torch.Tensor, idx: torch.Tensor,
              k: int) -> torch.Tensor:
    """(L, 16) f32 node-major table, (N,) int32 indices -> (k, N)
    tab_rows[idx, :k].T, the same values take_cols gives from the (k, L)
    table tab_rows[:, :k].T; indices outside [0, L) give 0 (take_rows
    kernel on the card, which reads records of 16 floats only)."""
    if tab_rows.is_cuda:
        return cuda_hist.take_rows(tab_rows, idx, k)
    return take_rows_plain(tab_rows, idx, k)


def seg_sum_plain(vals: torch.Tensor, idx: torch.Tensor,
                  num_out: int) -> torch.Tensor:
    k, N = vals.shape
    ok = (idx >= 0) & (idx < num_out)
    safe = torch.where(ok, idx, num_out).long()
    out = torch.zeros((k, num_out + 1), dtype=vals.dtype, device=vals.device)
    out.index_add_(1, safe, torch.where(ok[None, :], vals, 0.0))
    return out[:, :num_out]


def seg_sum(vals: torch.Tensor, idx: torch.Tensor, num_out: int,
            axis=None, n_rows: Optional[int] = None) -> torch.Tensor:
    """(k, N) values + (N,) int32 indices -> (k, num_out) per-index sums;
    out-of-range indices are dropped (seg_sum kernel on the card, whose
    int64 fixed-point sums give the same bits on every run). axis (a
    parallel.comm.Mesh, every rank's N equal) sums every rank's rows to
    the bits one device holding them all gives: on the card the
    kernel's int64 partials at the scale of the maxima over every rank
    and n_rows (the rows that device would pad to), reduced exactly; on
    the CPU the plain f32 version over the gathered rows, in rank order
    (a rank's padding rows add zeros or drop)."""
    if axis is not None:
        if not vals.is_cuda:
            return seg_sum_plain(
                torch.cat(list(axis.all_gather(vals)), dim=1),
                axis.all_gather(idx).reshape(-1), num_out)
        absmax = axis.all_reduce(
            vals.abs().amax(dim=1).to(torch.float32), "max")
        acc = cuda_hist.seg_sum(vals.contiguous(), idx.contiguous(),
                                num_out, (absmax, int(n_rows)))
        return fx_axis_reduce(acc, absmax, int(n_rows), axis)
    if vals.is_cuda:
        return cuda_hist.seg_sum(vals.contiguous(), idx.contiguous(),
                                 num_out)
    return seg_sum_plain(vals, idx, num_out)
