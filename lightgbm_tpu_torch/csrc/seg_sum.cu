// seg_sum: out[:, l] = sum of vals[:, r] over rows r with idx[r] == l;
// rows whose idx is outside [0, L) are dropped.
//
// Replaces the TPU kernel lightgbm_tpu/learner/pallas_hist.py seg_sum_tpu
// (_segsum_kernel), which contracts a one-hot tile on the matrix unit.
// The sums are f32 and must come out the same bits on every run (the
// port's rule that f32 reductions run in a fixed order), so there are no
// float atomics:
//   pass 1: block b stages rows [b R, (b + 1) R) of idx and vals in shared
//           memory; thread t owns the leaves l with l % blockDim == t and
//           walks the rows in order, adding the rows of its own leaves
//           into a (k, L) partial in shared memory that no other thread
//           writes. The partial goes to device memory as partials[b].
//   pass 2: one thread per (j, l) sums partials[0..B)[j, l] in block order.
// Both passes are fixed-order, so the result is bitwise reproducible.
//
// What bounds it: device-memory bytes at the main path's shapes (k = 2,
// L = 255: each row is read once). The pass-1 walk is the cost of this
// simple design: every thread of a block reads all R rows' leaf ids
// (R compares per thread) to find the rows of its own leaves.
#include <cstdint>
#include <cuda_runtime.h>

namespace lgbm_torch {

constexpr int kSegThreads = 256;

__global__ void seg_sum_partial_kernel(const float* __restrict__ vals,
                                       const int32_t* __restrict__ idx,
                                       float* __restrict__ partials, int k,
                                       int L, int N, int rows_per_blk) {
  extern __shared__ float sh[];
  float* part = sh;                           // (k, L)
  int* sidx = (int*)(part + k * L);           // (R,)
  float* svals = (float*)(sidx + rows_per_blk);  // (k, R)
  const int r0 = blockIdx.x * rows_per_blk;
  const int nr = min(rows_per_blk, N - r0);
  for (int i = threadIdx.x; i < k * L; i += blockDim.x) part[i] = 0.0f;
  for (int i = threadIdx.x; i < nr; i += blockDim.x) {
    sidx[i] = idx[r0 + i];
    for (int j = 0; j < k; ++j)
      svals[j * rows_per_blk + i] = vals[(int64_t)j * N + r0 + i];
  }
  __syncthreads();
  for (int i = 0; i < nr; ++i) {
    const int l = sidx[i];
    if (l < 0 || l >= L || l % blockDim.x != threadIdx.x) continue;
    for (int j = 0; j < k; ++j) part[j * L + l] += svals[j * rows_per_blk + i];
  }
  __syncthreads();
  float* dst = partials + (int64_t)blockIdx.x * k * L;
  for (int i = threadIdx.x; i < k * L; i += blockDim.x) dst[i] = part[i];
}

__global__ void seg_sum_reduce_kernel(const float* __restrict__ partials,
                                      float* __restrict__ out, int k, int L,
                                      int num_parts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k * L) return;
  float acc = 0.0f;
  for (int b = 0; b < num_parts; ++b) acc += partials[(int64_t)b * k * L + i];
  out[i] = acc;
}

}  // namespace lgbm_torch

extern "C" int lgbm_seg_sum(const void* vals, const void* idx, void* partials,
                            void* out, int k, int L, int N, int rows_per_blk,
                            void* stream) {
  using namespace lgbm_torch;
  const int num_parts = (N + rows_per_blk - 1) / rows_per_blk;
  const int smem = (k * L + rows_per_blk * (1 + k)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      seg_sum_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  seg_sum_partial_kernel<<<num_parts, kSegThreads, smem,
                           (cudaStream_t)stream>>>(
      (const float*)vals, (const int32_t*)idx, (float*)partials, k, L, N,
      rows_per_blk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = k * L;
  seg_sum_reduce_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)partials, (float*)out, k, L, num_parts);
  return (int)cudaGetLastError();
}
