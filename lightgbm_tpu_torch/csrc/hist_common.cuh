// Shared pieces of the histogram kernels (hist_nat.cu, hist_round.cu,
// hist.cu) and of seg_sum.cu: the layout, the fixed point and the channel
// loads that every one of them uses.
//
// Layout contract (the JAX package's, kept at the port's public functions):
//   bins  (G, N) int32, feature-major, row r of column g at bins[g * N + r]
//   gh    (3, N) channels: gradient, hessian, in-bag count — integer
//         levels, int32 (hist_nat, hist_round int16 mode) or int8 (their
//         int8 mode), or f32 values (hist, hist_slots, the f32 modes of
//         hist_nat and hist_round)
//   out   (S, 3, G, Bc) sums, out[((s * 3 + c) * G + g) * Bc + b]
//
// Integer levels are summed in int32 cells (shared-memory atomics, then
// partial tiles or an L2 accumulator): integer sums, exact and the same on
// every run whatever order the atomics land in. There are no float atomics
// in any of the kernels: f32 values are summed as int64 fixed point
// (below).
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

// Let kernel fn take `bytes` of dynamic shared memory on the current
// device: cudaFuncSetAttribute once per kernel, device and larger size.
inline int allow_smem(const void* fn, int bytes) {
  struct Seen {
    const void* fn;
    int dev, bytes;
  };
  static Seen seen[64];
  static int n_seen = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int i = 0;
  while (i < n_seen && !(seen[i].fn == fn && seen[i].dev == dev)) ++i;
  if (i < n_seen && bytes <= seen[i].bytes) return 0;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e != cudaSuccess) return (int)e;
  if (i < n_seen) seen[i].bytes = bytes;
  else if (n_seen < 64) seen[n_seen++] = Seen{fn, dev, bytes};
  return 0;
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
