// Shared pieces of the two histogram kernels (hist_nat.cu, hist_round.cu).
//
// Layout contract (the JAX package's, kept at the port's public functions):
//   bins  (G, N) int32, feature-major, row r of column g at bins[g * N + r]
//   gh    (3, N) int32 integer levels: gradient, hessian, in-bag count
//   out   (S, 3, G, Bc) int32 sums, out[((s * 3 + c) * G + g) * Bc + b]
//
// A block owns one tile of (slot chunk) x (column group) x (row chunk).
// It keeps the tile's Sc x 3 x Gc x Bc int32 histogram in shared memory,
// adds its rows with shared-memory atomicAdd, and flushes the non-zero
// cells to device memory with int32 atomicAdd. Integer sums are exact,
// so the result is the same on every run whatever order the atomics
// land in.
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

__device__ __forceinline__ void zero_smem(int* sh, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) sh[i] = 0;
}

// Add row r (already known to feed histogram slot s) into the tile.
__device__ __forceinline__ void add_row(int* sh, const HistTile& t,
                                        const int32_t* __restrict__ bins,
                                        int s, int r, int gq, int hq,
                                        int cq) {
  const int sl = s - t.s0;
  if (sl < 0 || sl >= t.Sc) return;
  const int gn = min(t.Gc, t.G - t.g0);
  for (int gl = 0; gl < gn; ++gl) {
    const int b = bins[(int64_t)(t.g0 + gl) * t.N + r];
    if (b < 0 || b >= t.Bc) continue;  // matches no bin, as a one-hot would
    int* cell = sh + ((sl * 3) * t.Gc + gl) * t.Bc + b;
    if (gq) atomicAdd(cell, gq);
    if (hq) atomicAdd(cell + t.Gc * t.Bc, hq);
    if (cq) atomicAdd(cell + 2 * t.Gc * t.Bc, cq);
  }
}

__device__ __forceinline__ void flush_tile(const int* sh, const HistTile& t,
                                           int32_t* __restrict__ out) {
  const int n = t.Sc * 3 * t.Gc * t.Bc;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int v = sh[i];
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

}  // namespace lgbm_torch
