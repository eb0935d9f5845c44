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
//     (hist_common.cuh), with the scale taken over all N rows by one
//     absmax launch before and one fx_to_f32 launch after (both in
//     hist.cu). No host read, no float atomics.
// The TPU builds a one-hot tile per row block and contracts it on the
// matrix unit; Hopper has shared-memory atomics, so this kernel scatters
// each row straight into a shared-memory histogram instead (no one-hot, no
// slot caps from on-chip memory other than the 227 KB a block may use).
//
// What bounds it: device-memory bytes. Every row's bin is read once per
// column, its slot and channels once per column group; the atomics stay
// in shared memory. The grid splits rows into chunks so that a few blocks
// per SM are in flight; a block covers as many columns as its shared
// memory holds, so gh and slot are read once per column group, not once
// per column. Slots that do not fit one block's shared memory become a
// third grid dimension (slot chunks): the refit's 255 slots of 256 int64
// bins take 7 chunks, each reading every row's slot.
//
// Exactness: integer sums, int32 atomics for the levels (the wrapper
// refuses inputs whose worst-case cell sum, rows x levels, reaches 2^31),
// int64 for the fixed point.
#include "hist_common.cuh"

namespace lgbm_torch {

// Val: int32_t or int8_t levels with Acc = int, or float values with
// Acc = fx_t (absmax_bits and log2_rows give the fixed-point exponents;
// unused for the integer modes).
template <typename Val, typename Acc>
__global__ void hist_nat_kernel(const int32_t* __restrict__ bins,
                                const Val* __restrict__ gh,
                                const int32_t* __restrict__ slot,
                                const unsigned* __restrict__ absmax_bits,
                                int log2_rows, Acc* __restrict__ out, int G,
                                int N, int S, int Bc, int Sc, int Gc,
                                int rows_per_blk) {
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* sh = reinterpret_cast<Acc*>(smem);
  const HistTile t = make_tile(G, N, S, Bc, Sc, Gc, rows_per_blk);
  zero_smem(sh, Sc * 3 * Gc * Bc);
  int k[3] = {0, 0, 0};
  if (absmax_bits != nullptr)
    for (int c = 0; c < 3; ++c)
      k[c] = fx_exponent(absmax_bits[c], log2_rows);
  __syncthreads();
  for (int r = t.r0 + threadIdx.x; r < t.r1; r += blockDim.x) {
    const int s = slot[r];
    if (s < t.s0 || s >= t.s0 + Sc || s >= S) continue;
    Acc v0, v1, v2;
    load_vals(gh, N, r, k, v0, v1, v2);
    add_row(sh, t, bins, s, r, v0, v1, v2);
  }
  __syncthreads();
  flush_tile(sh, t, out);
}

template <typename Val, typename Acc>
int launch_hist_nat(const void* bins, const void* gh, const void* slot,
                    const unsigned* absmax_bits, int log2_rows, void* out,
                    int G, int N, int S, int Bc, int Sc, int Gc,
                    int rows_per_blk, cudaStream_t stream) {
  const int smem = Sc * 3 * Gc * Bc * (int)sizeof(Acc);
  cudaError_t err = cudaFuncSetAttribute(
      hist_nat_kernel<Val, Acc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + rows_per_blk - 1) / rows_per_blk, (G + Gc - 1) / Gc,
            (S + Sc - 1) / Sc);
  hist_nat_kernel<Val, Acc><<<grid, kThreads, smem, stream>>>(
      (const int32_t*)bins, (const Val*)gh, (const int32_t*)slot,
      absmax_bits, log2_rows, (Acc*)out, G, N, S, Bc, Sc, Gc, rows_per_blk);
  return (int)cudaGetLastError();
}

}  // namespace lgbm_torch

// int16 mode: gh (3, N) int32 levels, out (S, 3, G, Bc) int32 zeroed.
extern "C" int lgbm_hist_nat(const void* bins, const void* gh,
                             const void* slot, void* out, int G, int N,
                             int S, int Bc, int Sc, int Gc,
                             int rows_per_blk, void* stream) {
  using namespace lgbm_torch;
  return launch_hist_nat<int32_t, int>(bins, gh, slot, nullptr, 0, out, G,
                                       N, S, Bc, Sc, Gc, rows_per_blk,
                                       (cudaStream_t)stream);
}

// int8 mode: gh (3, N) int8 levels, out (S, 3, G, Bc) int32 zeroed.
extern "C" int lgbm_hist_nat_int8(const void* bins, const void* gh,
                                  const void* slot, void* out, int G, int N,
                                  int S, int Bc, int Sc, int Gc,
                                  int rows_per_blk, void* stream) {
  using namespace lgbm_torch;
  return launch_hist_nat<int8_t, int>(bins, gh, slot, nullptr, 0, out, G, N,
                                      S, Bc, Sc, Gc, rows_per_blk,
                                      (cudaStream_t)stream);
}

// f32 mode: gh (3, N) f32; absmax_bits (3,) and acc (S, 3, G, Bc) int64
// zeroed by the caller; out (S, 3, G, Bc) f32.
extern "C" int lgbm_hist_nat_f32(const void* bins, const void* gh,
                                 const void* slot, void* absmax_bits,
                                 void* acc, void* out, int G, int N, int S,
                                 int Bc, int Sc, int Gc, int rows_per_blk,
                                 int log2_rows, void* stream) {
  using namespace lgbm_torch;
  cudaStream_t st = (cudaStream_t)stream;
  int err = launch_absmax((const float*)gh, N, nullptr, N,
                          (unsigned*)absmax_bits, st);
  if (err) return err;
  err = launch_hist_nat<float, fx_t>(bins, gh, slot,
                                     (const unsigned*)absmax_bits, log2_rows,
                                     acc, G, N, S, Bc, Sc, Gc, rows_per_blk,
                                     st);
  if (err) return err;
  return launch_fx_to_f32((const fx_t*)acc, (const unsigned*)absmax_bits,
                          log2_rows, (float*)out, (long long)S * 3 * G * Bc,
                          G * Bc, st);
}
