// take_small: out[:, r] = tab[:, idx[r]], 0 where idx[r] is outside [0, L).
//
// Replaces the TPU kernel lightgbm_tpu/learner/pallas_hist.py
// take_small_tpu (_take_kernel). The TPU has no vector gather, so it
// multiplies the table by a one-hot tile on the matrix unit; Hopper
// gathers directly. The (k, L) f32 table is staged in shared memory once
// per block (8 KB at k = 8, L = 255) and each thread serves rows of a
// grid-stride loop, so loads of idx and stores of out are coalesced.
// A table too large for shared memory is read from device memory
// through the read-only cache instead. The result is exact f32: a copy.
//
// What bounds it: device-memory bytes (4 per index read, 4k per row
// written).
#include <cstdint>
#include <cuda_runtime.h>

namespace lgbm_torch {

constexpr int kTakeThreads = 256;
constexpr int kTakeSmemBytes = 48 * 1024;

template <bool kStaged>
__global__ void take_small_kernel(const float* __restrict__ tab,
                                  const int32_t* __restrict__ idx,
                                  float* __restrict__ out, int k, int L,
                                  int N) {
  extern __shared__ float sh_tab[];
  const float* t = tab;
  if (kStaged) {
    for (int i = threadIdx.x; i < k * L; i += blockDim.x) sh_tab[i] = tab[i];
    __syncthreads();
    t = sh_tab;
  }
  const int stride = gridDim.x * blockDim.x;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < N; r += stride) {
    const int i = idx[r];
    const bool ok = i >= 0 && i < L;
    for (int j = 0; j < k; ++j) {
      float v = 0.0f;
      if (ok) v = kStaged ? t[j * L + i] : __ldg(t + (int64_t)j * L + i);
      out[(int64_t)j * N + r] = v;
    }
  }
}

}  // namespace lgbm_torch

extern "C" int lgbm_take_small(const void* tab, const void* idx, void* out,
                               int k, int L, int N, int num_blocks,
                               void* stream) {
  using namespace lgbm_torch;
  const int bytes = k * L * (int)sizeof(float);
  if (bytes <= kTakeSmemBytes) {
    take_small_kernel<true><<<num_blocks, kTakeThreads, bytes,
                              (cudaStream_t)stream>>>(
        (const float*)tab, (const int32_t*)idx, (float*)out, k, L, N);
  } else {
    take_small_kernel<false><<<num_blocks, kTakeThreads, 0,
                               (cudaStream_t)stream>>>(
        (const float*)tab, (const int32_t*)idx, (float*)out, k, L, N);
  }
  return (int)cudaGetLastError();
}
