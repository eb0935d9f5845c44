// Shared pieces of the histogram kernels (hist_nat.cu, hist_round.cu,
// hist.cu) and of seg_sum.cu: the layout, the fixed point and channel loads
// that every one of them uses, and the tile of hist_nat's integer modes
// (HistTile, add_row, flush_tile).
//
// Layout contract (the JAX package's, kept at the port's public functions):
//   bins  (G, N) int32, feature-major, row r of column g at bins[g * N + r]
//   gh    (3, N) channels: gradient, hessian, in-bag count — integer
//         levels, int32 (hist_nat, hist_round int16 mode) or int8 (their
//         int8 mode), or f32 values (hist, hist_slots, the f32 modes of
//         hist_nat and hist_round)
//   out   (S, 3, G, Bc) sums, out[((s * 3 + c) * G + g) * Bc + b]
//
// In hist_nat's integer modes a block owns one tile of (slot chunk) x
// (column group) x (row chunk). It keeps the tile's Sc x 3 x Gc x Bc int32
// histogram in shared memory, adds its rows with shared-memory atomicAdd,
// and flushes the non-zero cells to device memory with atomicAdd. The
// cells are integers, so the sums are exact and the result is the same on
// every run whatever order the atomics land in. There are no float
// atomics in any of the kernels: f32 values are summed as int64 fixed
// point (below).
//
// Fixed point for f32 channels. Per call and channel c, with n a bound on
// the rows any cell sums and max |value| < 2^e over the call's rows:
//   k = 62 - ceil(log2 n) - e,  q = round-half-even(value * 2^k) in int64,
// so |q| < 2^(62 - ceil(log2 n)) and no cell sum reaches 2^62. The
// result is (float)((double)sum * 2^-k). Each value is rounded to
// 2^-(62 - ceil(log2 n)) of the channel's max: 2^-42 at n = 2^20 rows,
// which keeps the sum within f32 rounding of the true sum (2^-24) for
// any n below ~2^38. The plain PyTorch versions (learner/histogram.py
// fx_*) do the same arithmetic, so kernel and plain agree bit for bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lgbm_torch {

// Largest dynamic shared memory a block may ask for on sm_90 (227 KB).
constexpr int kMaxSmemBytes = 232448;
constexpr int kThreads = 512;

struct HistTile {
  int G, N, S, Bc;          // full problem
  int Sc, Gc, rows_per_blk;  // tile extents
  int s0, g0, r0, r1;       // this block's tile origin / row range
};

__device__ __forceinline__ HistTile make_tile(int G, int N, int S, int Bc,
                                              int Sc, int Gc,
                                              int rows_per_blk) {
  HistTile t;
  t.G = G; t.N = N; t.S = S; t.Bc = Bc;
  t.Sc = Sc; t.Gc = Gc; t.rows_per_blk = rows_per_blk;
  t.r0 = blockIdx.x * rows_per_blk;
  t.r1 = min(N, t.r0 + rows_per_blk);
  t.g0 = blockIdx.y * Gc;
  t.s0 = blockIdx.z * Sc;
  return t;
}

template <typename Acc>
__device__ __forceinline__ void zero_smem(Acc* sh, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) sh[i] = 0;
}

// Add row r (already known to feed histogram slot s) into the tile. Acc
// is int (integer levels) or unsigned long long (fixed point, added in
// two's complement).
template <typename Acc>
__device__ __forceinline__ void add_row(Acc* sh, const HistTile& t,
                                        const int32_t* __restrict__ bins,
                                        int s, int r, Acc gq, Acc hq,
                                        Acc cq) {
  const int sl = s - t.s0;
  if (sl < 0 || sl >= t.Sc) return;
  const int gn = min(t.Gc, t.G - t.g0);
  for (int gl = 0; gl < gn; ++gl) {
    const int b = bins[(int64_t)(t.g0 + gl) * t.N + r];
    if (b < 0 || b >= t.Bc) continue;  // matches no bin, as a one-hot would
    Acc* cell = sh + ((sl * 3) * t.Gc + gl) * t.Bc + b;
    if (gq) atomicAdd(cell, gq);
    if (hq) atomicAdd(cell + t.Gc * t.Bc, hq);
    if (cq) atomicAdd(cell + 2 * t.Gc * t.Bc, cq);
  }
}

template <typename Acc>
__device__ __forceinline__ void flush_tile(const Acc* sh, const HistTile& t,
                                           Acc* __restrict__ out) {
  const int n = t.Sc * 3 * t.Gc * t.Bc;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const Acc v = sh[i];
    if (v == 0) continue;
    const int b = i % t.Bc;
    const int gl = (i / t.Bc) % t.Gc;
    const int c = (i / (t.Bc * t.Gc)) % 3;
    const int sl = i / (t.Bc * t.Gc * 3);
    const int s = t.s0 + sl, g = t.g0 + gl;
    if (s >= t.S || g >= t.G) continue;
    atomicAdd(out + (((int64_t)s * 3 + c) * t.G + g) * t.Bc + b, v);
  }
}

// ---- fixed point (see the top of this file)
typedef unsigned long long fx_t;
constexpr int kFxBits = 62;

__device__ __forceinline__ int fx_exponent(unsigned absmax_bits,
                                           int log2_rows) {
  int e;
  frexpf(__uint_as_float(absmax_bits), &e);
  return kFxBits - log2_rows - e;
}

__device__ __forceinline__ fx_t fx_quant(float v, int k) {
  return (fx_t)__double2ll_rn(ldexp((double)v, k));
}

// Row r's three channels: integer levels (int32 or int8) as they are,
// f32 values as fixed point with the per-channel exponents k.
__device__ __forceinline__ void load_vals(const int32_t* __restrict__ gh,
                                          int64_t ld, int r, const int*,
                                          int& v0, int& v1, int& v2) {
  v0 = gh[r];
  v1 = gh[ld + r];
  v2 = gh[2 * ld + r];
}

__device__ __forceinline__ void load_vals(const int8_t* __restrict__ gh,
                                          int64_t ld, int r, const int*,
                                          int& v0, int& v1, int& v2) {
  v0 = gh[r];
  v1 = gh[ld + r];
  v2 = gh[2 * ld + r];
}

__device__ __forceinline__ void load_vals(const float* __restrict__ gh,
                                          int64_t ld, int r, const int* k,
                                          fx_t& v0, fx_t& v1, fx_t& v2) {
  v0 = fx_quant(gh[r], k[0]);
  v1 = fx_quant(gh[ld + r], k[1]);
  v2 = fx_quant(gh[2 * ld + r], k[2]);
}

}  // namespace lgbm_torch
