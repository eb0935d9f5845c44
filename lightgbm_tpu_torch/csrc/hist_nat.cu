// hist_nat: per-slot gradient histograms keyed by a row -> slot vector.
//
// Replaces the TPU kernel lightgbm_tpu/learner/pallas_hist.py hist_nat_tpu
// (_nat_kernel), int16 mode: 3 integer channels (gradient level, hessian
// level, count), slot S is the trash slot. The TPU builds a one-hot tile
// per row block and contracts it on the matrix unit; Hopper has
// shared-memory atomics, so this kernel scatters each row straight into
// a shared-memory histogram instead (no one-hot, no SWAR bytes, no slot
// caps from on-chip memory other than the 227 KB a block may use).
//
// What bounds it: device-memory bytes. Every row's bin is read once per
// column, its slot and three levels once per column group; the atomics
// stay in shared memory. The grid splits rows into chunks so that a few
// blocks per SM are in flight; a block covers as many columns as its
// shared memory holds, so gh and slot are read once per column group,
// not once per column. Slots that do not fit one block's shared memory
// become a third grid dimension (slot chunks).
//
// Exactness: integer sums, int32 atomics; the wrapper refuses inputs
// whose worst-case cell sum (rows x levels) reaches 2^31.
#include "hist_common.cuh"

namespace lgbm_torch {

__global__ void hist_nat_kernel(const int32_t* __restrict__ bins,
                                const int32_t* __restrict__ gh,
                                const int32_t* __restrict__ slot,
                                int32_t* __restrict__ out, int G, int N,
                                int S, int Bc, int Sc, int Gc,
                                int rows_per_blk) {
  extern __shared__ int sh[];
  const HistTile t = make_tile(G, N, S, Bc, Sc, Gc, rows_per_blk);
  zero_smem(sh, Sc * 3 * Gc * Bc);
  __syncthreads();
  for (int r = t.r0 + threadIdx.x; r < t.r1; r += blockDim.x) {
    const int s = slot[r];
    if (s < t.s0 || s >= t.s0 + Sc || s >= S) continue;
    add_row(sh, t, bins, s, r, gh[r], gh[(int64_t)N + r],
            gh[2 * (int64_t)N + r]);
  }
  __syncthreads();
  flush_tile(sh, t, out);
}

}  // namespace lgbm_torch

extern "C" int lgbm_hist_nat(const void* bins, const void* gh,
                             const void* slot, void* out, int G, int N,
                             int S, int Bc, int Sc, int Gc,
                             int rows_per_blk, void* stream) {
  using namespace lgbm_torch;
  const int smem = Sc * 3 * Gc * Bc * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      hist_nat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + rows_per_blk - 1) / rows_per_blk, (G + Gc - 1) / Gc,
            (S + Sc - 1) / Sc);
  hist_nat_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)bins, (const int32_t*)gh, (const int32_t*)slot,
      (int32_t*)out, G, N, S, Bc, Sc, Gc, rows_per_blk);
  return (int)cudaGetLastError();
}
