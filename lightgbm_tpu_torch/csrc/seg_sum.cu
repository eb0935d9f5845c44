// seg_sum: out[:, l] = sum of vals[:, r] over rows r with idx[r] == l;
// rows whose idx is outside [0, L) are dropped.
//
// Replaces the TPU kernel lightgbm_tpu/learner/pallas_hist.py seg_sum_tpu
// (_segsum_kernel), which contracts a one-hot tile on the matrix unit.
// The sums must come out the same bits on every run, and float atomics
// land in no fixed order, so the values are summed as int64 fixed point
// (hist_common.cuh: per channel, max |value| over all N rows sets the
// scale; integer sums are exact in any order). Two launches:
//   1. prepass: per-block channel maxima into parts[block][k] (plain
//      stores, so nothing needs zeroing first), and the zeroing of the
//      (k, L) int64 accumulator and of the done counter;
//   2. the sums in one pass over the rows: a grid of about two blocks per
//      SM, each walking its rows 4 at a time (16-byte loads of idx and of
//      each channel where aligned), adds each quantized value into a
//      (k, L) int64 tile in shared memory (4 KB at k = 2, L = 255) with
//      64-bit shared atomics, then adds the tile's non-zero cells into
//      the L2-resident accumulator with 64-bit global atomics: ~2 x SMs x
//      k x L flush atomics a call. The last block to finish (a counter
//      bumped after a __threadfence) converts the k x L sums to f32.
// The exponents come from the maxima over all N rows (each block reduces
// the <= 256 x k maxima with one warp), so every launch gives the same
// bits. Each value is rounded to 2^-(62 - ceil(log2 N)) of its channel's
// max: 2^-42 at N = 2^20 rows, more accurate than the f32 sequential sum
// the previous design computed, and not the same bits as the plain
// version's f32 index_add_ (within rtol 1e-5 of it).
//
// What bounds it: device-memory bytes, (k + 1) x 4 B a row read once; at
// k = 2 over 1,001,472 rows that is 12 MB, ~3.6 us at 3.35 TB/s.
#include "hist_common.cuh"

namespace lgbm_torch {

constexpr int kSegMaxK = 3;
constexpr int kSegThreads = 256;
constexpr int kSegPartsMax = 256;

__global__ void seg_prepass_kernel(const float* __restrict__ vals, int k,
                                   int N, int vec,
                                   unsigned* __restrict__ parts,
                                   fx_t* __restrict__ acc, int cells,
                                   unsigned* __restrict__ done) {
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = tid; i < cells; i += stride) acc[i] = 0;
  if (tid == 0) *done = 0;
  unsigned m[kSegMaxK] = {0, 0, 0};
#pragma unroll
  for (int j = 0; j < kSegMaxK; ++j) {
    if (j >= k) break;
    const float* v = vals + (int64_t)j * N;
    if (vec) {  // N % 4 == 0 and vals 16-byte aligned
      for (int64_t q = tid; q < N / 4; q += stride) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(v) + q);
        m[j] = max(m[j], max(max(__float_as_uint(fabsf(x.x)),
                                 __float_as_uint(fabsf(x.y))),
                             max(__float_as_uint(fabsf(x.z)),
                                 __float_as_uint(fabsf(x.w)))));
      }
    } else {
      for (int64_t r = tid; r < N; r += stride)
        m[j] = max(m[j], __float_as_uint(fabsf(v[r])));
    }
  }
  __shared__ unsigned wm[kSegMaxK][kSegThreads / 32];
  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kSegMaxK; ++j) {
    const unsigned x = __reduce_max_sync(0xffffffffu, m[j]);
    if ((threadIdx.x & 31) == 0) wm[j][w] = x;
  }
  __syncthreads();
  if (threadIdx.x < k) {
    unsigned x = 0;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i)
      x = max(x, wm[threadIdx.x][i]);
    parts[k * blockIdx.x + threadIdx.x] = x;
  }
}

// Channels are unrolled to kSegMaxK and predicated on k, so the per-row
// arrays stay in registers.
__device__ __forceinline__ void seg_add(fx_t* tile, int L, int k, int l,
                                        const float (&v)[kSegMaxK],
                                        const int (&kx)[kSegMaxK]) {
  if (l < 0 || l >= L) return;
#pragma unroll
  for (int j = 0; j < kSegMaxK; ++j) {
    if (j >= k) break;
    const fx_t q = fx_quant(v[j], kx[j]);
    if (q != 0) atomicAdd(tile + j * L + l, q);
  }
}

__global__ void seg_sum_kernel(const float* __restrict__ vals,
                               const int32_t* __restrict__ idx, int k, int L,
                               int N, int vec,
                               const unsigned* __restrict__ parts,
                               int nparts, int log2_rows,
                               const unsigned* __restrict__ max_in,
                               fx_t* __restrict__ acc,
                               unsigned* __restrict__ done,
                               float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  fx_t* tile = reinterpret_cast<fx_t*>(smem);  // (k, L)
  __shared__ int kx[kSegMaxK];
  __shared__ bool last;
  const int cells = k * L;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) tile[i] = 0;
  if (threadIdx.x < 32) {  // the exponents: one warp over the maxima
    unsigned m[kSegMaxK] = {0, 0, 0};
    for (int p = threadIdx.x; p < nparts; p += 32)
#pragma unroll
      for (int j = 0; j < kSegMaxK; ++j)
        if (j < k) m[j] = max(m[j], __ldg(parts + k * p + j));
#pragma unroll
    for (int j = 0; j < kSegMaxK; ++j) {
      const unsigned x = __reduce_max_sync(0xffffffffu, m[j]);
      if (threadIdx.x == 0 && j < k)
        kx[j] = fx_exponent(max_in != nullptr ? max_in[j] : x, log2_rows);
    }
  }
  __syncthreads();
  int kr[kSegMaxK];
#pragma unroll
  for (int j = 0; j < kSegMaxK; ++j) kr[j] = j < k ? kx[j] : 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (vec) {  // N % 4 == 0, idx and vals 16-byte aligned
    for (int64_t q = tid; q < N / 4; q += stride) {
      const int4 l4 = __ldg(reinterpret_cast<const int4*>(idx) + q);
      float v[4][kSegMaxK] = {};
#pragma unroll
      for (int j = 0; j < kSegMaxK; ++j) {
        if (j >= k) break;
        const float4 x = __ldg(
            reinterpret_cast<const float4*>(vals + (int64_t)j * N) + q);
        v[0][j] = x.x; v[1][j] = x.y; v[2][j] = x.z; v[3][j] = x.w;
      }
      seg_add(tile, L, k, l4.x, v[0], kr);
      seg_add(tile, L, k, l4.y, v[1], kr);
      seg_add(tile, L, k, l4.z, v[2], kr);
      seg_add(tile, L, k, l4.w, v[3], kr);
    }
  } else {
    for (int64_t r = tid; r < N; r += stride) {
      float v[kSegMaxK] = {};
#pragma unroll
      for (int j = 0; j < kSegMaxK; ++j)
        if (j < k) v[j] = vals[(int64_t)j * N + r];
      seg_add(tile, L, k, idx[r], v, kr);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x)
    if (tile[i] != 0) atomicAdd(acc + i, tile[i]);
  // the last block to finish converts the sums
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < cells; i += blockDim.x)
    out[i] = (float)ldexp((double)(long long)__ldcg(acc + i),
                          -kx[i / L]);
}

}  // namespace lgbm_torch

// vals (k, N) f32, k <= 3, idx (N,) int32, N >= 1; scratch: k * L int64
// words (the accumulator), then one word whose low half is the done
// counter, then (nparts * k) uint32 maxima; out (k, L) f32. vec: N % 4
// == 0 and vals / idx 16-byte aligned. max_in: null, or a sharded run's
// (k,) channel maxima over every rank (f32 bits), which set the
// exponents in place of these rows'; the int64 sums stay in the
// scratch's accumulator after the call either way.
extern "C" int lgbm_seg_sum(const void* vals, const void* idx, void* scratch,
                            void* out, int k, int L, int N, int blocks,
                            int nparts, int log2_rows, int vec,
                            const void* max_in, void* stream) {
  using namespace lgbm_torch;
  if (k < 1 || k > kSegMaxK || nparts < 1 || nparts > kSegPartsMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int cells = k * L;
  fx_t* acc = (fx_t*)scratch;
  unsigned* done = (unsigned*)(acc + cells);
  unsigned* parts = (unsigned*)(acc + cells + 1);
  seg_prepass_kernel<<<nparts, kSegThreads, 0, st>>>(
      (const float*)vals, k, N, vec, parts, acc, cells, done);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int smem = cells * (int)sizeof(fx_t);
  cudaError_t e = cudaFuncSetAttribute(
      seg_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  seg_sum_kernel<<<blocks, kSegThreads, smem, st>>>(
      (const float*)vals, (const int32_t*)idx, k, L, N, vec, parts, nparts,
      log2_rows, (const unsigned*)max_in, acc, done, (float*)out);
  return (int)cudaGetLastError();
}
