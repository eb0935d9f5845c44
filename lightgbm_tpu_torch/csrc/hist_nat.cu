// hist_nat: per-slot gradient histograms keyed by a row -> slot vector.
//
// Replaces the TPU kernel lightgbm_tpu/learner/pallas_hist.py hist_nat_tpu
// (_nat_kernel) in its three modes, slot S being the trash slot:
//   - int16 mode: 3 int32 channels (gradient level, hessian level, count);
//   - int8 mode (use_quantized_grad, tpu_hist_dtype=int8): the same levels
//     within +-127 read as int8, 3 bytes per row instead of 12. The TPU
//     runs s8 x s8 -> s32 on its matrix unit with a SWAR one-hot scale
//     (oh_shift, int4 nibbles); those are encodings for the matrix unit
//     and are not carried over: the function is the exact integer sums;
//   - f32 mode (nat_ch=5 on the TPU; the percentile leaf refit's
//     histograms, renewal.py): 3 f32 channels summed as int64 fixed point
//     (hist_common.cuh), with the scale taken over all N rows. Its own
//     kernels, below the integer modes' (see "f32 mode").
// The TPU builds a one-hot tile per row block and contracts it on the
// matrix unit; Hopper has shared-memory atomics, so the integer modes
// scatter each row straight into a shared-memory histogram instead (no
// one-hot, no slot caps from on-chip memory other than the 227 KB a block
// may use).
//
// What bounds the integer modes: device-memory bytes. Every row's bin is
// read once per column, its slot and channels once per column group; the
// atomics stay in shared memory. The grid splits rows into chunks so that
// a few blocks per SM are in flight; a block covers as many columns as its
// shared memory holds, so gh and slot are read once per column group, not
// once per column. Slots that do not fit one block's shared memory become
// a third grid dimension (slot chunks).
//
// Exactness: integer sums, int32 atomics for the levels (the wrapper
// refuses inputs whose worst-case cell sum, rows x levels, reaches 2^31),
// int64 for the fixed point.
#include <algorithm>

#include "hist_common.cuh"

namespace lgbm_torch {

// Val: int32_t or int8_t levels, summed in int32 cells.
template <typename Val>
__global__ void hist_nat_kernel(const int32_t* __restrict__ bins,
                                const Val* __restrict__ gh,
                                const int32_t* __restrict__ slot,
                                int* __restrict__ out, int G, int N, int S,
                                int Bc, int Sc, int Gc, int rows_per_blk) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* sh = reinterpret_cast<int*>(smem);
  const HistTile t = make_tile(G, N, S, Bc, Sc, Gc, rows_per_blk);
  zero_smem(sh, Sc * 3 * Gc * Bc);
  __syncthreads();
  for (int r = t.r0 + threadIdx.x; r < t.r1; r += blockDim.x) {
    const int s = slot[r];
    if (s < t.s0 || s >= t.s0 + Sc || s >= S) continue;
    int v0, v1, v2;
    load_vals(gh, N, r, nullptr, v0, v1, v2);
    add_row(sh, t, bins, s, r, v0, v1, v2);
  }
  __syncthreads();
  flush_tile(sh, t, out);
}

template <typename Val>
int launch_hist_nat(const void* bins, const void* gh, const void* slot,
                    void* out, int G, int N, int S, int Bc, int Sc, int Gc,
                    int rows_per_blk, cudaStream_t stream) {
  const int smem = Sc * 3 * Gc * Bc * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      hist_nat_kernel<Val>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + rows_per_blk - 1) / rows_per_blk, (G + Gc - 1) / Gc,
            (S + Sc - 1) / Sc);
  hist_nat_kernel<Val><<<grid, kThreads, smem, stream>>>(
      (const int32_t*)bins, (const Val*)gh, (const int32_t*)slot, (int*)out,
      G, N, S, Bc, Sc, Gc, rows_per_blk);
  return (int)cudaGetLastError();
}

}  // namespace lgbm_torch

// int16 mode: gh (3, N) int32 levels, out (S, 3, G, Bc) int32 zeroed.
extern "C" int lgbm_hist_nat(const void* bins, const void* gh,
                             const void* slot, void* out, int G, int N,
                             int S, int Bc, int Sc, int Gc,
                             int rows_per_blk, void* stream) {
  using namespace lgbm_torch;
  return launch_hist_nat<int32_t>(bins, gh, slot, out, G, N, S, Bc, Sc, Gc,
                                  rows_per_blk, (cudaStream_t)stream);
}

// int8 mode: gh (3, N) int8 levels, out (S, 3, G, Bc) int32 zeroed.
extern "C" int lgbm_hist_nat_int8(const void* bins, const void* gh,
                                  const void* slot, void* out, int G, int N,
                                  int S, int Bc, int Sc, int Gc,
                                  int rows_per_blk, void* stream) {
  using namespace lgbm_torch;
  return launch_hist_nat<int8_t>(bins, gh, slot, out, G, N, S, Bc, Sc, Gc,
                                 rows_per_blk, (cudaStream_t)stream);
}

// ---------------------------------------------------------------- f32 mode
//
// The refit's shape is one column, S = num_leaves leaf slots and Bc = 256
// bins over ~1M rows: at S = 255 an (S, 3, 1, Bc) int64 tile of ~1.5 MB,
// which no block's shared memory holds. The integer modes' design would
// cut it into 7 slot chunks, each block zeroing and scanning 28k shared
// cells for the ~1/7 of its rows that fall in its chunk. Here instead:
//   1. prepass (one launch): per-block channel maxima |value| into
//      parts[block][3] (no atomics, so nothing to zero first), and the
//      zeroing of the int64 accumulator;
//   2. the histogram in one pass over the rows: 4 rows per thread with
//      16-byte loads of slot, bins and the three channels; each non-zero
//      fixed-point value is added straight into the accumulator (1.5 MB
//      at S = 255, resident in the 50 MB L2) with a 64-bit global
//      atomicAdd. A row in the trash slot costs only its slot load. Each
//      block reduces parts to the exponents by itself (one warp reads
//      the <= 256 x 3 maxima from L2), so no launch sits between. This
//      serves every S: at S = 31, where the integer modes' shared tile
//      would fit one block, that tile took 0.091 ms of device time on a
//      refit's first pass against 0.076 here, and 0.032 against 0.014
//      on its fourth (H100, chip_smoke.py); the zeroing and the scan of
//      the tile cost more than the atomics it merges;
//   3. the int64 sums back to f32 (a third launch).
// No host read, no float atomics, no memset: 3 device operations a call.
// The arithmetic is that of the plain version (the exponents from the
// maxima over all N rows, fx_exponent; round-half-even to int64; exact
// int64 sums), so the result is the same bits on every launch.
//
// What bounds it: device-memory bytes of the prepass (12 B a row) and of
// the slot vector (4 B a row), plus 16 B per row in a slot; at ~1M rows
// that is ~20 MB, ~6 us at 3.35 TB/s. The atomics resolve in L2.

namespace lgbm_torch {

constexpr int kPartsMax = 256;      // prepass blocks (parts rows)
constexpr int kPrepassThreads = 256;
constexpr int kAtomicThreads = 256;

// The exponents from the prepass's maxima (every block, one warp's
// reduction), and block 0 keeps them after the maxima for the
// conversion launch.
__device__ __forceinline__ void block_exponents(unsigned* __restrict__ parts,
                                                int nparts, int log2_rows,
                                                int* k) {
  unsigned m0 = 0, m1 = 0, m2 = 0;
  for (int p = threadIdx.x & 31; p < nparts; p += 32) {
    m0 = max(m0, __ldg(parts + 3 * p));
    m1 = max(m1, __ldg(parts + 3 * p + 1));
    m2 = max(m2, __ldg(parts + 3 * p + 2));
  }
  k[0] = fx_exponent(__reduce_max_sync(0xffffffffu, m0), log2_rows);
  k[1] = fx_exponent(__reduce_max_sync(0xffffffffu, m1), log2_rows);
  k[2] = fx_exponent(__reduce_max_sync(0xffffffffu, m2), log2_rows);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (int c = 0; c < 3; ++c) parts[3 * nparts + c] = (unsigned)k[c];
}

__global__ void f32_prepass_kernel(const float* __restrict__ gh, int N,
                                   int vec, unsigned* __restrict__ parts,
                                   fx_t* __restrict__ acc,
                                   int64_t acc_words) {
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = tid; i < acc_words; i += stride) acc[i] = 0;
  unsigned m[3] = {0, 0, 0};
  if (vec) {  // N % 4 == 0 and gh 16-byte aligned
    for (int64_t q = tid; q < N / 4; q += stride) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float4 v =
            __ldg(reinterpret_cast<const float4*>(gh + (int64_t)c * N) + q);
        m[c] = max(m[c], max(max(__float_as_uint(fabsf(v.x)),
                                 __float_as_uint(fabsf(v.y))),
                             max(__float_as_uint(fabsf(v.z)),
                                 __float_as_uint(fabsf(v.w)))));
      }
    }
  } else {
    for (int64_t r = tid; r < N; r += stride)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        m[c] = max(m[c], __float_as_uint(fabsf(gh[(int64_t)c * N + r])));
  }
  __shared__ unsigned wm[3][kPrepassThreads / 32];
  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const unsigned v = __reduce_max_sync(0xffffffffu, m[c]);
    if ((threadIdx.x & 31) == 0) wm[c][w] = v;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    unsigned v = 0;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i)
      v = max(v, wm[threadIdx.x][i]);
    parts[3 * blockIdx.x + threadIdx.x] = v;
  }
}

// Cell i of acc to f32, channel (i / cells_per_channel) % 3.
__global__ void f32_convert_kernel(const fx_t* __restrict__ acc,
                                   const unsigned* __restrict__ parts,
                                   int nparts, float* __restrict__ out,
                                   int64_t n_cells, int cells_per_channel) {
  int k[3];
  for (int c = 0; c < 3; ++c) k[c] = (int)__ldg(parts + 3 * nparts + c);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < n_cells; i += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)((i / cells_per_channel) % 3);
    const int kc = c == 0 ? k[0] : c == 1 ? k[1] : k[2];  // no local array
    out[i] = (float)ldexp((double)(long long)__ldcg(acc + i), -kc);
  }
}

template <bool kVec>
__global__ void f32_atomic_kernel(const int32_t* __restrict__ bins,
                                  const float* __restrict__ gh,
                                  const int32_t* __restrict__ slot,
                                  unsigned* __restrict__ parts,
                                  int nparts, int log2_rows,
                                  fx_t* __restrict__ acc, int G, int N,
                                  int S, int Bc) {
  int k[3];
  block_exponents(parts, nparts, log2_rows, k);
  const int64_t cpc = (int64_t)G * Bc;  // cells per channel
  const int64_t groups = ((int64_t)N + 3) / 4;
  for (int64_t q = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       q < groups; q += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r0 = q * 4;
    const int nr = (int)min((int64_t)4, N - r0);
    int s[4];
    if (kVec && nr == 4) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(slot) + q);
      s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) s[t] = t < nr ? slot[r0 + t] : S;
    }
    bool in[4], any = false;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      in[t] = s[t] >= 0 && s[t] < S;
      any |= in[t];
    }
    if (!any) continue;  // the trash slot: the slot load only
    fx_t v[3][4];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float f[4];
      const float* ch = gh + (int64_t)c * N;
      if (kVec && nr == 4) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(ch) + q);
        f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) f[t] = in[t] ? ch[r0 + t] : 0.0f;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) v[c][t] = in[t] ? fx_quant(f[t], k[c]) : 0;
    }
    for (int g = 0; g < G; ++g) {
      int b[4];
      const int32_t* bg = bins + (int64_t)g * N;
      if (kVec && nr == 4) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(bg) + q);
        b[0] = x.x; b[1] = x.y; b[2] = x.z; b[3] = x.w;
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) b[t] = in[t] ? bg[r0 + t] : -1;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        // a bin outside [0, Bc) matches no cell, as a one-hot would
        if (!in[t] || b[t] < 0 || b[t] >= Bc) continue;
        fx_t* cell = acc + ((int64_t)s[t] * 3 * G + g) * Bc + b[t];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          if (v[c][t] != 0) atomicAdd(cell + c * cpc, v[c][t]);
      }
    }
  }
}

}  // namespace lgbm_torch

// f32 mode: bins (G, N) int32, gh (3, N) f32, slot (N,) int32 in [0, S],
// N >= 1; parts (nparts + 1, 3) uint32 scratch (the maxima, then the
// exponents); acc (S * 3 * G * Bc) int64 scratch (zeroed here); out
// (S, 3, G, Bc) f32, not empty. vec: N % 4 == 0 and bins / gh / slot
// 16-byte aligned.
extern "C" int lgbm_hist_nat_f32(const void* bins, const void* gh,
                                 const void* slot, void* parts, void* acc,
                                 void* out, int G, int N, int S, int Bc,
                                 int blocks, int nparts, int log2_rows,
                                 int vec, void* stream) {
  using namespace lgbm_torch;
  if (nparts < 1 || nparts > kPartsMax) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t n_cells = (int64_t)S * 3 * G * Bc;
  unsigned* pr = (unsigned*)parts;
  fx_t* ac = (fx_t*)acc;
  f32_prepass_kernel<<<nparts, kPrepassThreads, 0, st>>>(
      (const float*)gh, N, vec, pr, ac, n_cells);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if (vec)
    f32_atomic_kernel<true><<<blocks, kAtomicThreads, 0, st>>>(
        (const int32_t*)bins, (const float*)gh, (const int32_t*)slot, pr,
        nparts, log2_rows, ac, G, N, S, Bc);
  else
    f32_atomic_kernel<false><<<blocks, kAtomicThreads, 0, st>>>(
        (const int32_t*)bins, (const float*)gh, (const int32_t*)slot, pr,
        nparts, log2_rows, ac, G, N, S, Bc);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int cblocks = (int)std::min<int64_t>((n_cells + 255) / 256, 4096);
  f32_convert_kernel<<<cblocks, 256, 0, st>>>(ac, pr, nparts, (float*)out,
                                              n_cells, G * Bc);
  return (int)cudaGetLastError();
}
