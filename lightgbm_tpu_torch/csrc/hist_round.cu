// hist_round: one pass per growth round that partitions the split leaves'
// rows and builds the smaller children's histograms.
//
// Replaces the TPU kernel lightgbm_tpu/learner/pallas_hist.py
// hist_round_tpu (_round_kernel), int16 mode (3 integer channels,
// numerical splits). Per row it
//   - finds the row's split slot s from its leaf id through a leaf -> slot
//     table built in shared memory from the (S, 16) params (the TPU kernel
//     compares against every slot and contracts a column one-hot on the
//     matrix unit; Hopper reads bins[col_s, r] directly),
//   - decodes the EFB bundle column (params 7..9), tests
//     fb <= thr | (default_left & fb == nan_bin),
//   - writes the new row -> leaf id (right child) — only the blocks of
//     column group 0 and slot chunk 0 write it, the others recompute the
//     decision and discard it,
//   - adds the row to slot s's histogram when it went to the smaller
//     child, exactly as hist_nat does (hist_common.cuh).
//
// params columns (S, 16) int32: 0 leaf id being split (-1 = unused slot),
// 1 device column, 2 threshold bin, 3 default_left, 4 NaN bin (-1 none),
// 5 left child is the smaller, 6 right child's new leaf id, 7 EFB off_lo,
// 8 EFB most-frequent bin (-1 = direct column), 9 EFB width, 10 categorical
// (not supported here: the wrapper refuses categorical splits).
//
// What bounds it: device-memory bytes, as hist_nat, plus one read of the
// split column per row. Limits: num_leaves + 1 table entries and the
// params must fit in shared memory beside the histogram tile (the
// wrapper checks).
#include "hist_common.cuh"

namespace lgbm_torch {

constexpr int kParamCols = 16;

__global__ void hist_round_kernel(
    const int32_t* __restrict__ bins, const int32_t* __restrict__ gh,
    const int32_t* __restrict__ pleaf, const int32_t* __restrict__ params,
    int32_t* __restrict__ out, int32_t* __restrict__ pleaf_new, int G,
    int N, int S, int Bc, int L, int Sc, int Gc, int rows_per_blk) {
  extern __shared__ int sh[];
  const HistTile t = make_tile(G, N, S, Bc, Sc, Gc, rows_per_blk);
  const int hist_n = Sc * 3 * Gc * Bc;
  int* table = sh + hist_n;          // (L + 1,) leaf -> slot
  int* prm = table + (L + 1);        // (S, 16) params
  zero_smem(sh, hist_n);
  for (int i = threadIdx.x; i <= L; i += blockDim.x) table[i] = -1;
  for (int i = threadIdx.x; i < S * kParamCols; i += blockDim.x)
    prm[i] = params[i];
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int leaf = prm[s * kParamCols];
    if (leaf >= 0 && leaf <= L) table[leaf] = s;
  }
  __syncthreads();
  const bool writer = blockIdx.y == 0 && blockIdx.z == 0;
  for (int r = t.r0 + threadIdx.x; r < t.r1; r += blockDim.x) {
    const int p = pleaf[r];
    const int s = (p >= 0 && p <= L) ? table[p] : -1;
    if (s < 0) {
      if (writer) pleaf_new[r] = p;
      continue;
    }
    const int* q = prm + s * kParamCols;
    int fb = bins[(int64_t)q[1] * N + r];
    const int mfb = q[8];
    if (mfb >= 0) {
      const int tt = fb - q[7];
      fb = (tt >= 0 && tt < q[9]) ? tt + (tt >= mfb ? 1 : 0) : mfb;
    }
    const bool go_left = fb <= q[2] || (q[3] != 0 && fb == q[4]);
    if (writer) pleaf_new[r] = go_left ? p : q[6];
    if (go_left == (q[5] != 0)) {
      add_row(sh, t, bins, s, r, gh[r], gh[(int64_t)N + r],
              gh[2 * (int64_t)N + r]);
    }
  }
  __syncthreads();
  flush_tile(sh, t, out);
}

}  // namespace lgbm_torch

extern "C" int lgbm_hist_round(const void* bins, const void* gh,
                               const void* pleaf, const void* params,
                               void* out, void* pleaf_new, int G, int N,
                               int S, int Bc, int L, int Sc, int Gc,
                               int rows_per_blk, void* stream) {
  using namespace lgbm_torch;
  const int smem =
      (Sc * 3 * Gc * Bc + (L + 1) + S * kParamCols) * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      hist_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + rows_per_blk - 1) / rows_per_blk, (G + Gc - 1) / Gc,
            (S + Sc - 1) / Sc);
  hist_round_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)bins, (const int32_t*)gh, (const int32_t*)pleaf,
      (const int32_t*)params, (int32_t*)out, (int32_t*)pleaf_new, G, N, S,
      Bc, L, Sc, Gc, rows_per_blk);
  return (int)cudaGetLastError();
}
