// hist_round: one pass per growth round that partitions the split leaves'
// rows and builds the smaller children's histograms.
//
// Replaces the TPU kernel lightgbm_tpu/learner/pallas_hist.py
// hist_round_tpu (_round_kernel), in three channel modes:
// int16 (3 int32 integer-level channels, int32 cells), int8 (the same
// levels within +-127 read as int8 — use_quantized_grad's 4 levels,
// tpu_hist_dtype=int8 — int32 cells; the TPU's s8 matrix-unit encoding
// and SWAR one-hot scale are not carried over) and f32 (the TPU's
// 5-channel bf16x2 mode; here 3 f32 channels summed as int64 fixed point,
// hist_common.cuh, with the scale taken over all N rows by one absmax
// launch before and one fx_to_f32 launch after — both in hist.cu). Each
// mode has a categorical variant (HasCat, the TPU kernel's has_cat,
// pallas_hist.py:416-432) for datasets with categorical features. Per
// row it
//   - finds the row's split slot s from its leaf id through a leaf -> slot
//     table built in shared memory from the (S, 16) params (the TPU kernel
//     compares against every slot and contracts a column one-hot on the
//     matrix unit; Hopper reads bins[col_s, r] directly),
//   - decodes the EFB bundle column (params 7..9), tests
//     fb <= thr | (default_left & fb == nan_bin) — or, on a categorical
//     slot (params 10), whether fb is in the slot's category set: one bit
//     of a per-slot bitset that each block builds in shared memory from
//     the (S, Bc) bool mask, one warp ballot per 32 bins (S x ceil(Bc /
//     32) words; the TPU contracts an (S, B) s8 mask with a bin one-hot
//     on its matrix unit instead). A bin outside [0, Bc) is in no set,
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
// (HasCat only: the slot's rows go left iff their bin is in its set).
//
// What bounds it: device-memory bytes, as hist_nat, plus one read of the
// split column per row. Limits: num_leaves + 1 table entries and the
// params (and the category bitsets) must fit in shared memory beside the
// histogram tile (the wrapper checks).
#include "hist_common.cuh"

namespace lgbm_torch {

constexpr int kParamCols = 16;

// Words of one slot's category bitset.
__host__ __device__ constexpr int cat_words(int Bc) { return (Bc + 31) / 32; }

// Val: int32_t or int8_t levels with Acc = int, or float values with
// Acc = fx_t
// (absmax_bits and log2_rows give the fixed-point exponents; unused for
// the integer mode). HasCat: cat_mask holds the (S, Bc) bool category
// sets; without it the numerical code is all there is.
template <typename Val, typename Acc, bool HasCat>
__global__ void hist_round_kernel(
    const int32_t* __restrict__ bins, const Val* __restrict__ gh,
    const int32_t* __restrict__ pleaf, const int32_t* __restrict__ params,
    const bool* __restrict__ cat_mask,
    const unsigned* __restrict__ absmax_bits, int log2_rows,
    Acc* __restrict__ out, int32_t* __restrict__ pleaf_new, int G, int N,
    int S, int Bc, int L, int Sc, int Gc, int rows_per_blk) {
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* sh = reinterpret_cast<Acc*>(smem);
  const HistTile t = make_tile(G, N, S, Bc, Sc, Gc, rows_per_blk);
  const int hist_n = Sc * 3 * Gc * Bc;
  int* table = reinterpret_cast<int*>(sh + hist_n);  // (L + 1,) leaf -> slot
  int* prm = table + (L + 1);        // (S, 16) params
  const int W = cat_words(Bc);
  unsigned* cbits = reinterpret_cast<unsigned*>(prm + S * kParamCols);
  zero_smem(sh, hist_n);
  for (int i = threadIdx.x; i <= L; i += blockDim.x) table[i] = -1;
  for (int i = threadIdx.x; i < S * kParamCols; i += blockDim.x)
    prm[i] = params[i];
  if (HasCat) {  // word w: bins 32 (w % W) .. + 31 of slot w / W; one warp
                 // a word (blockDim is a multiple of 32)
    const int lane = threadIdx.x & 31;
    for (int w = threadIdx.x >> 5; w < S * W; w += blockDim.x >> 5) {
      const int b = (w % W) * 32 + lane;
      const bool in = b < Bc && cat_mask[(int64_t)(w / W) * Bc + b];
      const unsigned word = __ballot_sync(0xffffffffu, in);
      if (lane == 0) cbits[w] = word;
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int leaf = prm[s * kParamCols];
    if (leaf >= 0 && leaf <= L) table[leaf] = s;
  }
  __syncthreads();
  int k[3] = {0, 0, 0};
  if (absmax_bits != nullptr)
    for (int c = 0; c < 3; ++c)
      k[c] = fx_exponent(absmax_bits[c], log2_rows);
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
    bool go_left;
    if (HasCat && q[10] != 0)
      go_left = fb >= 0 && fb < Bc
                && ((cbits[s * W + (fb >> 5)] >> (fb & 31)) & 1u);
    else
      go_left = fb <= q[2] || (q[3] != 0 && fb == q[4]);
    if (writer) pleaf_new[r] = go_left ? p : q[6];
    if (go_left == (q[5] != 0)) {
      Acc v0, v1, v2;
      load_vals(gh, N, r, k, v0, v1, v2);
      add_row(sh, t, bins, s, r, v0, v1, v2);
    }
  }
  __syncthreads();
  flush_tile(sh, t, out);
}

template <typename Val, typename Acc, bool HasCat>
int launch_hist_round_mode(const void* bins, const void* gh,
                           const void* pleaf, const void* params,
                           const bool* cat_mask,
                           const unsigned* absmax_bits, int log2_rows,
                           void* out, void* pleaf_new, int G, int N, int S,
                           int Bc, int L, int Sc, int Gc, int rows_per_blk,
                           cudaStream_t stream) {
  const int smem = Sc * 3 * Gc * Bc * (int)sizeof(Acc)
                   + ((L + 1) + S * kParamCols
                      + (HasCat ? S * cat_words(Bc) : 0)) * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      hist_round_kernel<Val, Acc, HasCat>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + rows_per_blk - 1) / rows_per_blk, (G + Gc - 1) / Gc,
            (S + Sc - 1) / Sc);
  hist_round_kernel<Val, Acc, HasCat><<<grid, kThreads, smem, stream>>>(
      (const int32_t*)bins, (const Val*)gh, (const int32_t*)pleaf,
      (const int32_t*)params, cat_mask, absmax_bits, log2_rows, (Acc*)out,
      (int32_t*)pleaf_new, G, N, S, Bc, L, Sc, Gc, rows_per_blk);
  return (int)cudaGetLastError();
}

// cat_mask == nullptr: the numerical kernel; else the categorical one.
template <typename Val, typename Acc>
int launch_hist_round(const void* bins, const void* gh, const void* pleaf,
                      const void* params, const void* cat_mask,
                      const unsigned* absmax_bits, int log2_rows, void* out,
                      void* pleaf_new, int G, int N, int S, int Bc, int L,
                      int Sc, int Gc, int rows_per_blk, cudaStream_t stream) {
  if (cat_mask != nullptr)
    return launch_hist_round_mode<Val, Acc, true>(
        bins, gh, pleaf, params, (const bool*)cat_mask, absmax_bits,
        log2_rows, out, pleaf_new, G, N, S, Bc, L, Sc, Gc, rows_per_blk,
        stream);
  return launch_hist_round_mode<Val, Acc, false>(
      bins, gh, pleaf, params, nullptr, absmax_bits, log2_rows, out,
      pleaf_new, G, N, S, Bc, L, Sc, Gc, rows_per_blk, stream);
}

}  // namespace lgbm_torch

// The modes' entry points. cat_mask: (S, Bc) bool category sets (bin b
// of slot s goes left), or null when no slot can be categorical.
// int16 mode: gh (3, N) int32 levels, out (S, 3, G, Bc) int32 zeroed.
extern "C" int lgbm_hist_round(const void* bins, const void* gh,
                               const void* pleaf, const void* params,
                               const void* cat_mask, void* out,
                               void* pleaf_new, int G, int N, int S, int Bc,
                               int L, int Sc, int Gc, int rows_per_blk,
                               void* stream) {
  using namespace lgbm_torch;
  return launch_hist_round<int32_t, int>(
      bins, gh, pleaf, params, cat_mask, nullptr, 0, out, pleaf_new, G, N,
      S, Bc, L, Sc, Gc, rows_per_blk, (cudaStream_t)stream);
}

// int8 mode: gh (3, N) int8 levels, out (S, 3, G, Bc) int32 zeroed.
extern "C" int lgbm_hist_round_int8(const void* bins, const void* gh,
                                    const void* pleaf, const void* params,
                                    const void* cat_mask, void* out,
                                    void* pleaf_new, int G, int N, int S,
                                    int Bc, int L, int Sc, int Gc,
                                    int rows_per_blk, void* stream) {
  using namespace lgbm_torch;
  return launch_hist_round<int8_t, int>(
      bins, gh, pleaf, params, cat_mask, nullptr, 0, out, pleaf_new, G, N,
      S, Bc, L, Sc, Gc, rows_per_blk, (cudaStream_t)stream);
}

// f32 mode: gh (3, N) f32; absmax_bits (3,) and acc (S, 3, G, Bc) int64
// zeroed by the caller; out (S, 3, G, Bc) f32.
extern "C" int lgbm_hist_round_f32(const void* bins, const void* gh,
                                   const void* pleaf, const void* params,
                                   const void* cat_mask, void* absmax_bits,
                                   void* acc, void* out, void* pleaf_new,
                                   int G, int N, int S, int Bc, int L,
                                   int Sc, int Gc, int rows_per_blk,
                                   int log2_rows, void* stream) {
  using namespace lgbm_torch;
  cudaStream_t st = (cudaStream_t)stream;
  int err = launch_absmax((const float*)gh, N, nullptr, N,
                          (unsigned*)absmax_bits, st);
  if (err) return err;
  err = launch_hist_round<float, fx_t>(
      bins, gh, pleaf, params, cat_mask, (const unsigned*)absmax_bits,
      log2_rows, acc, pleaf_new, G, N, S, Bc, L, Sc, Gc, rows_per_blk, st);
  if (err) return err;
  return launch_fx_to_f32((const fx_t*)acc, (const unsigned*)absmax_bits,
                          log2_rows, (float*)out, (long long)S * 3 * G * Bc,
                          G * Bc, st);
}
