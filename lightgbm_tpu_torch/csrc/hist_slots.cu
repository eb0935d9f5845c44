// hist_slots: per-slot f32 gradient histograms over disjoint contiguous
// row segments, all slots in one launch.
//
// Replaces the TPU kernel lightgbm_tpu/learner/pallas_hist.py
// hist_slots_tpu (_hist_slots_kernel): the round phase of the exact
// grower (tpu_growth_rounds) keeps rows grouped by leaf, so every smaller
// child of a round is one segment [begin_s, begin_s + count_s) of the
// permuted matrix. The TPU kernel walks a scalar-prefetched visit plan of
// (slot, row block) pairs over a sequential grid and carries each slot's
// histogram in VMEM; Hopper's blocks run in no order, so here
//   1. plan: one thread turns the counts into visit offsets,
//      vstart[s] = sum over t < s of ceil(count_t / R) (the prefix sum of
//      pallas_hist.py:704-728), vstart[S] = the number of visits;
//   2. hist_slots_kernel: block x is visit x (blocks past vstart[S] exit),
//      block y a column group. It finds its slot by binary search in
//      vstart, accumulates its R rows into a 3 x Gc x Bc int64 fixed-point
//      tile in shared memory and flushes it into slot s with int64
//      atomics (hist_common.cuh: exact, order-free, bitwise repeatable);
//   3. fx_to_f32: the sums back to (S, 3, G, Bc) f32.
// The fixed-point scale is taken over all N rows (absmax, hist.cu), so a
// slot's result does not depend on which other slots the call holds.
// Empty slots have no visits and come out zero. The grid is sized on the
// host from the bound sum(ceil(count_s / R)) <= N / R + S, which holds
// because the segments are disjoint rows of [0, N).
//
// What bounds it: device-memory bytes — each segment row's G bins and 3
// channels are read once per column group; rows outside every segment
// are not read at all.
#include "hist_common.cuh"

namespace lgbm_torch {

__global__ void slots_plan_kernel(const int32_t* __restrict__ begins,
                                  const int32_t* __restrict__ counts, int S,
                                  int N, int rows_per_visit,
                                  int32_t* __restrict__ vstart) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  int acc = 0;
  for (int s = 0; s < S; ++s) {
    vstart[s] = acc;
    const int b = begins[s];
    const int c = (b < 0 || b >= N) ? 0 : min(max(counts[s], 0), N - b);
    acc += (c + rows_per_visit - 1) / rows_per_visit;
  }
  vstart[S] = acc;
}

__global__ void hist_slots_kernel(const int32_t* __restrict__ bins,
                                  const float* __restrict__ gh,
                                  const int32_t* __restrict__ begins,
                                  const int32_t* __restrict__ counts,
                                  const int32_t* __restrict__ vstart,
                                  const unsigned* __restrict__ absmax_bits,
                                  int log2_rows, fx_t* __restrict__ acc,
                                  int G, int N, int S, int Bc, int Gc,
                                  int rows_per_visit) {
  extern __shared__ __align__(16) unsigned char smem[];
  fx_t* sh = reinterpret_cast<fx_t*>(smem);
  const int v = blockIdx.x;
  if (v >= vstart[S]) return;  // the whole block: past the last visit
  // the last slot s with vstart[s] <= v; empty slots share their
  // successor's offset, so the search lands on a non-empty slot
  int lo = 0, hi = S - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (vstart[mid] <= v) lo = mid; else hi = mid - 1;
  }
  const int s = lo;
  const int b = begins[s];
  const int end = b + min(max(counts[s], 0), N - b);
  HistTile t;
  t.G = G; t.N = N; t.S = S; t.Bc = Bc;
  t.Sc = 1; t.Gc = Gc; t.rows_per_blk = rows_per_visit;
  t.s0 = s;
  t.g0 = blockIdx.y * Gc;
  t.r0 = b + (v - vstart[s]) * rows_per_visit;
  t.r1 = min(end, t.r0 + rows_per_visit);
  int k[3];
  for (int c = 0; c < 3; ++c) k[c] = fx_exponent(absmax_bits[c], log2_rows);
  zero_smem(sh, 3 * Gc * Bc);
  __syncthreads();
  for (int r = t.r0 + threadIdx.x; r < t.r1; r += blockDim.x) {
    fx_t v0, v1, v2;
    load_vals(gh, N, r, k, v0, v1, v2);
    add_row(sh, t, bins, s, r, v0, v1, v2);
  }
  __syncthreads();
  flush_tile(sh, t, acc);
}

}  // namespace lgbm_torch

// bins (G, N), gh (3, N) f32, begins/counts (S,) int32 on the device;
// vstart (S + 1,) int32 scratch; absmax_bits (3,) and acc (S, 3, G, Bc)
// int64 zeroed by the caller; max_visits = N / R + S rounded up.
extern "C" int lgbm_hist_slots(const void* bins, const void* gh,
                               const void* begins, const void* counts,
                               void* vstart, void* absmax_bits, void* acc,
                               void* out, int G, int N, int S, int Bc,
                               int Gc, int rows_per_visit, int max_visits,
                               int log2_rows, void* stream) {
  using namespace lgbm_torch;
  cudaStream_t st = (cudaStream_t)stream;
  int err = launch_absmax((const float*)gh, N, nullptr, N,
                          (unsigned*)absmax_bits, st);
  if (err) return err;
  slots_plan_kernel<<<1, 32, 0, st>>>((const int32_t*)begins,
                                      (const int32_t*)counts, S, N,
                                      rows_per_visit, (int32_t*)vstart);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int smem = 3 * Gc * Bc * (int)sizeof(fx_t);
  cudaError_t e = cudaFuncSetAttribute(
      hist_slots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(max_visits, (G + Gc - 1) / Gc);
  hist_slots_kernel<<<grid, kThreads, smem, st>>>(
      (const int32_t*)bins, (const float*)gh, (const int32_t*)begins,
      (const int32_t*)counts, (const int32_t*)vstart,
      (const unsigned*)absmax_bits, log2_rows, (fx_t*)acc, G, N, S, Bc, Gc,
      rows_per_visit);
  err = (int)cudaGetLastError();
  if (err) return err;
  return launch_fx_to_f32((const fx_t*)acc, (const unsigned*)absmax_bits,
                          log2_rows, (float*)out, (long long)S * 3 * G * Bc,
                          G * Bc, st);
}
