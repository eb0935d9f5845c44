// hist: one f32 gradient histogram over a contiguous row range.
//
// Replaces the TPU kernel lightgbm_tpu/learner/pallas_hist.py hist_tpu
// (_hist_kernel, _accum_hist_nt): bins (G, N) int32 and the bf16x2-split
// channels (8, N) -> (8, G*Bc) f32, contracted on the matrix unit with a
// one-hot tile per row block. Here the channels are (3, N) f32 (gradient,
// hessian, count; the hi/lo split only fed the TPU's bf16 matrix unit) and
// the rows are [begin, begin + count) of the matrix, with begin and count
// read from device memory: the sequential grower asks for its smaller
// child's segment without reading the bounds back to the host. The launch
// covers `cap` rows (a host bound on count); blocks past count exit.
//
// Three launches, all on the caller's stream:
//   1. absmax: per-channel max |value| over the range (fixed-point scale);
//   2. hist_kernel: a block owns (row chunk) x (column group), keeps the
//      3 x Gc x Bc int64 fixed-point histogram in shared memory, adds its
//      rows with shared-memory atomics and flushes with int64 atomics
//      (hist_common.cuh: exact integer sums, the same bits on every run);
//   3. fx_to_f32: the int64 sums back to (3, G, Bc) f32.
//
// What bounds it: device-memory bytes — each row's G bins and 3 channels
// are read once per column group. The cost of the simple design: 64-bit
// shared-memory atomics, and a flush of the whole tile per row chunk.
#include <algorithm>

#include "hist_common.cuh"

namespace lgbm_torch {

constexpr int kAbsmaxThreads = 256;

__global__ void absmax_kernel(const float* __restrict__ gh, int64_t ld,
                              const int32_t* __restrict__ range, int n,
                              unsigned* __restrict__ absmax_bits) {
  const int begin = range ? range[0] : 0;
  const int count = range ? min(range[1], n) : n;
  unsigned m0 = 0, m1 = 0, m2 = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += gridDim.x * blockDim.x) {
    const int r = begin + i;
    m0 = max(m0, __float_as_uint(fabsf(gh[r])));
    m1 = max(m1, __float_as_uint(fabsf(gh[ld + r])));
    m2 = max(m2, __float_as_uint(fabsf(gh[2 * ld + r])));
  }
  m0 = __reduce_max_sync(0xffffffffu, m0);
  m1 = __reduce_max_sync(0xffffffffu, m1);
  m2 = __reduce_max_sync(0xffffffffu, m2);
  if ((threadIdx.x & 31) == 0) {
    if (m0) atomicMax(absmax_bits, m0);
    if (m1) atomicMax(absmax_bits + 1, m1);
    if (m2) atomicMax(absmax_bits + 2, m2);
  }
}

__global__ void fx_to_f32_kernel(const fx_t* __restrict__ acc,
                                 const unsigned* __restrict__ absmax_bits,
                                 int log2_rows, float* __restrict__ out,
                                 int64_t n_cells, int cells_per_channel) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < n_cells; i += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)((i / cells_per_channel) % 3);
    const int k = fx_exponent(absmax_bits[c], log2_rows);
    out[i] = (float)ldexp((double)(long long)acc[i], -k);
  }
}

int launch_absmax(const float* gh, int64_t ld, const int32_t* range, int n,
                  unsigned* absmax_bits, cudaStream_t stream) {
  const int blocks =
      std::max(1, std::min((n + kAbsmaxThreads - 1) / kAbsmaxThreads, 1056));
  absmax_kernel<<<blocks, kAbsmaxThreads, 0, stream>>>(gh, ld, range, n,
                                                       absmax_bits);
  return (int)cudaGetLastError();
}

int launch_fx_to_f32(const fx_t* acc, const unsigned* absmax_bits,
                     int log2_rows, float* out, int64_t n_cells,
                     int cells_per_channel, cudaStream_t stream) {
  const int blocks = (int)std::min<int64_t>((n_cells + 255) / 256, 4096);
  fx_to_f32_kernel<<<blocks, 256, 0, stream>>>(
      acc, absmax_bits, log2_rows, out, n_cells, cells_per_channel);
  return (int)cudaGetLastError();
}

__global__ void hist_kernel(const int32_t* __restrict__ bins,
                            const float* __restrict__ gh, int64_t ld,
                            const int32_t* __restrict__ range,
                            const unsigned* __restrict__ absmax_bits,
                            int log2_rows, fx_t* __restrict__ acc, int G,
                            int Bc, int Gc, int rows_per_blk) {
  extern __shared__ __align__(16) unsigned char smem[];
  fx_t* sh = reinterpret_cast<fx_t*>(smem);
  const int begin = range[0], count = range[1];
  const int off = blockIdx.x * rows_per_blk;
  if (off >= count) return;  // the whole block: past the segment's end
  HistTile t;
  t.G = G; t.N = (int)ld; t.S = 1; t.Bc = Bc;
  t.Sc = 1; t.Gc = Gc; t.rows_per_blk = rows_per_blk;
  t.s0 = 0;
  t.g0 = blockIdx.y * Gc;
  t.r0 = begin + off;
  t.r1 = begin + min(count, off + rows_per_blk);
  int k[3];
  for (int c = 0; c < 3; ++c) k[c] = fx_exponent(absmax_bits[c], log2_rows);
  zero_smem(sh, 3 * Gc * Bc);
  __syncthreads();
  for (int r = t.r0 + threadIdx.x; r < t.r1; r += blockDim.x) {
    fx_t v0, v1, v2;
    load_vals(gh, ld, r, k, v0, v1, v2);
    add_row(sh, t, bins, 0, r, v0, v1, v2);
  }
  __syncthreads();
  flush_tile(sh, t, acc);
}

}  // namespace lgbm_torch

// bins, gh: the (G, ld) / (3, ld) matrices; range: device int32 (begin,
// count); absmax_bits (3,) and acc (3, G, Bc) int64 zeroed by the caller.
extern "C" int lgbm_hist(const void* bins, const void* gh, long long ld,
                         const void* range, void* absmax_bits, void* acc,
                         void* out, int G, int Bc, int Gc, int rows_per_blk,
                         int cap, int log2_rows, void* stream) {
  using namespace lgbm_torch;
  cudaStream_t st = (cudaStream_t)stream;
  int err = launch_absmax((const float*)gh, ld, (const int32_t*)range, cap,
                          (unsigned*)absmax_bits, st);
  if (err) return err;
  const int smem = 3 * Gc * Bc * (int)sizeof(fx_t);
  cudaError_t e = cudaFuncSetAttribute(
      hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((cap + rows_per_blk - 1) / rows_per_blk, (G + Gc - 1) / Gc);
  hist_kernel<<<grid, kThreads, smem, st>>>(
      (const int32_t*)bins, (const float*)gh, ld, (const int32_t*)range,
      (const unsigned*)absmax_bits, log2_rows, (fx_t*)acc, G, Bc, Gc,
      rows_per_blk);
  err = (int)cudaGetLastError();
  if (err) return err;
  return launch_fx_to_f32((const fx_t*)acc, (const unsigned*)absmax_bits,
                          log2_rows, (float*)out, 3LL * G * Bc, G * Bc, st);
}
