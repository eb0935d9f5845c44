// hist_round: one growth round: partition the split leaves' rows and build
// the smaller children's histograms.
//
// Replaces the TPU kernel lightgbm_tpu/learner/pallas_hist.py
// hist_round_tpu (_round_kernel), in three channel modes: int16 (3 int32
// integer-level channels, int32 cells), int8 (the same levels within +-127
// read as int8 — use_quantized_grad's 4 levels, tpu_hist_dtype=int8 —
// int32 cells; the TPU's s8 matrix-unit encoding and SWAR one-hot scale
// are not carried over) and f32 (the TPU's 5-channel bf16x2 mode; here 3
// f32 channels summed as int64 fixed point, hist_common.cuh, the scale
// taken over all N rows). Each mode has a categorical variant (HasCat,
// the TPU kernel's has_cat, pallas_hist.py:416-432).
//
// The TPU kernel streams every row through each column block, contracting
// a slot one-hot on the matrix unit. On Hopper the rows that feed a
// histogram are a small share of N after the first rounds (a smaller
// child holds at most half its parent's rows), so the work is cut in two
// launches that read every row once and then only the rows that count:
//
// 1. Partition (round_partition_kernel, 2048 rows a block). Each block
//    builds in shared memory the leaf -> slot table from the (S, 16)
//    params, the params, and (HasCat) each slot's category set as a
//    bitset (one warp ballot per 32 bins). Per row it reads pleaf and, for
//    a row of a split leaf, the split column's bin; decodes the EFB
//    bundle column (params 7..9); tests fb <= thr | (default_left & fb ==
//    nan_bin), or on a categorical slot (params 10) whether fb is in the
//    slot's set (a bin outside [0, Bc) is in none); writes the new row ->
//    leaf. A row that goes to its slot's smaller child and whose count
//    channel is non-zero is kept: the block counts its kept rows per slot
//    (shared atomics), scans the counts, and writes the rows grouped by
//    slot into its own stretch of the row list, list[r0, r0 + kept) (one
//    shared atomic per slot and warp, ranks by ballot, so rows stay in
//    order within a warp). Rows of zero count are left out: every caller
//    zeroes their gradient and hessian with the same in-bag mask, so they
//    add nothing (and out-of-bag rows stay out of the list once bagging
//    samples). Per (slot, block) the count and the stretch's start go to
//    device memory; per slot the block adds its count to a running total.
//    The f32 mode also takes each block's channel maxima over all its
//    rows. The last block to finish (a counter bumped after a
//    __threadfence) turns the totals into the work list of the second
//    launch: a slot of T kept rows becomes max(1, min(slot_items,
//    ceil(T / chunk))) (slot, chunk) items of equal rows. It also reduces
//    the maxima to the fixed-point exponents, and resets the totals and
//    its counter to zero for the next call.
// 2. Histogram (round_hist_kernel), a grid of (item bound, column group)
//    blocks sized on the host from an upper bound on the items;
//    blocks past the work list exit at once. A block scans its slot's
//    per-block counts into shared memory, maps each of its chunk's
//    positions to a row of the list by binary search, gathers the row's
//    channels and its bins in the group's columns, and adds them into a
//    (3, Gc, Bc) tile in shared memory (int32 cells, int64 in the f32
//    mode; 12 / 24 KB at Gc = 4, Bc = 256: several blocks a SM). A slot
//    held by one item writes its tile to the output whole, as f32, with
//    plain stores: no zeroing, no atomics, no conversion launch. A slot
//    of several items (the first rounds of a tree) adds its non-zero
//    cells into an L2-resident accumulator with global atomics; the last
//    of its items (per column group, a counter bumped after a
//    __threadfence) converts the cells to f32 and zeroes them again.
// The accumulator, the totals and the counters live in scratch that the
// wrapper allocates zeroed once and every call leaves zeroed. No host
// read, no float atomics; every sum is an integer sum, so the output is
// the plain version's bits (hist_round_plain), whatever order the
// atomics land in.
//
// params columns (S, 16) int32: 0 leaf id being split (-1 = unused slot),
// 1 device column, 2 threshold bin, 3 default_left, 4 NaN bin (-1 none),
// 5 left child is the smaller, 6 right child's new leaf id, 7 EFB off_lo,
// 8 EFB most-frequent bin (-1 = direct column), 9 EFB width, 10 categorical
// (HasCat only: the slot's rows go left iff their bin is in its set).
//
// What bounds it: device-memory bytes. The partition reads pleaf and
// writes the new ids (8 B a row), plus one split-column bin and one count
// per row of a split leaf; the histogram gathers, per kept row, its three
// channels and its G bins (a 32-byte sector each when the kept rows are
// sparse). The limits (rows, slots, leaves, bins) that fit shared memory
// are the wrapper's (cuda_hist.hist_round_plan).
#include <type_traits>

#include "hist_common.cuh"

namespace lgbm_torch {

constexpr int kParamCols = 16;
constexpr int kPartThreads = 256;
constexpr int kPartRowsPerThread = 8;
constexpr int kPartRows = kPartThreads * kPartRowsPerThread;  // 2048
constexpr int kRoundHistThreads = 256;
constexpr int kRoundMaxCols = 8;  // columns of a histogram block, at most
constexpr int kU = 2;  // positions a histogram thread loads at a time

// Words of one slot's category bitset.
__host__ __device__ constexpr int cat_words(int Bc) { return (Bc + 31) / 32; }

// The round's scratch, carved from the wrapper's buffers (round_bufs).
struct RoundBufs {
  int* done_part;   // the partition's finished-block counter
  int* tot;         // (S,) kept rows per slot, summed over blocks
  int* done_hist;   // (S, column groups) finished items of a slot
  int* n_items;     // items of the histogram launch
  int* exps;        // (3,) fixed-point exponents (f32 mode)
  int* rows_of;     // (S,) kept rows per slot
  int* items_of;    // (S,) its items
  int* chunk_of;    // (S,) kept rows per item (the last item: the rest)
  int* item_slot;   // (max_items,)
  int* item_chunk;  // (max_items,)
  int* cnt;         // (S, NB) kept rows per slot and partition block
  int* seg;         // (S, NB) where that block's rows of the slot start
  unsigned* parts;  // (NB, 3) channel maxima per block (f32 mode)
  int* list;        // (N,) kept rows, grouped by block, then by slot
};

// dst[i] = src[0] + ... + src[i - 1] for i <= n; every thread of the block
// calls it (blockDim a multiple of 32); ends with __syncthreads.
__device__ void block_exclusive_scan(const int* src, int n, int* dst) {
  __shared__ int warp_sum[32];
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int b = min(n, (int)threadIdx.x * per), e = min(n, b + per);
  int sum = 0;
  for (int i = b; i < e; ++i) sum += src[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < (int)(blockDim.x >> 5) ? warp_sum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    warp_sum[lane] = t;
  }
  __syncthreads();
  int run = x - sum + (warp > 0 ? warp_sum[warp - 1] : 0);
  for (int i = b; i < e; ++i) {
    dst[i] = run;
    run += src[i];
  }
  if (threadIdx.x == blockDim.x - 1)
    dst[n] = warp_sum[(blockDim.x >> 5) - 1];
  __syncthreads();
}

template <typename Val, bool HasCat>
__global__ void __launch_bounds__(kPartThreads) round_partition_kernel(
    const int32_t* __restrict__ bins, const Val* __restrict__ gh,
    const int32_t* __restrict__ pleaf, const int32_t* __restrict__ params,
    const bool* __restrict__ cat_mask, int32_t* __restrict__ pleaf_new,
    RoundBufs w, int N, int S, int Bc, int L, int NB, int chunk,
    int slot_items, int log2_rows) {
  constexpr bool kF32 = std::is_same<Val, float>::value;
  extern __shared__ __align__(16) int sm[];
  int* table = sm;                   // (L + 1,) leaf -> slot
  int* prm = table + (L + 1);        // (S, 16) params
  int* scnt = prm + S * kParamCols;  // (S,) kept rows per slot
  int* soff = scnt + S;              // (S + 1,) their offsets, then cursors
  unsigned* cbits = reinterpret_cast<unsigned*>(soff + S + 1);  // (S, W)
  __shared__ unsigned wmax[3][kPartThreads / 32];
  __shared__ bool last;
  const int W = cat_words(Bc);
  for (int i = threadIdx.x; i <= L; i += blockDim.x) table[i] = -1;
  for (int i = threadIdx.x; i < S * kParamCols; i += blockDim.x)
    prm[i] = params[i];
  for (int i = threadIdx.x; i < S; i += blockDim.x) scnt[i] = 0;
  if (HasCat) {  // word w: bins 32 (w % W) .. + 31 of slot w / W; one warp
                 // a word
    const int lane = threadIdx.x & 31;
    for (int q = threadIdx.x >> 5; q < S * W; q += blockDim.x >> 5) {
      const int b = (q % W) * 32 + lane;
      const bool in = b < Bc && cat_mask[(int64_t)(q / W) * Bc + b];
      const unsigned word = __ballot_sync(0xffffffffu, in);
      if (lane == 0) cbits[q] = word;
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int leaf = prm[s * kParamCols];
    if (leaf >= 0 && leaf <= L) table[leaf] = s;
  }
  __syncthreads();

  const int r0 = blockIdx.x * kPartRows;
  const int64_t ld = N;
  // in three waves of independent loads over the thread's rows: the
  // leaf ids; the split column's bins and the counts; then the decisions
  constexpr int U = kPartRowsPerThread;
  int p[U], s[U], fb[U], kept[U];
  bool cnt_nz[U];
  unsigned m0 = 0, m1 = 0, m2 = 0;
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int r = r0 + i * kPartThreads + threadIdx.x;
    p[i] = r < N ? pleaf[r] : -1;
    if constexpr (kF32) {  // the scale is taken over all N rows
      if (r < N) {
        m0 = max(m0, __float_as_uint(fabsf(gh[r])));
        m1 = max(m1, __float_as_uint(fabsf(gh[ld + r])));
        m2 = max(m2, __float_as_uint(fabsf(gh[2 * ld + r])));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int r = r0 + i * kPartThreads + threadIdx.x;
    s[i] = (r < N && p[i] >= 0 && p[i] <= L) ? table[p[i]] : -1;
    fb[i] = s[i] >= 0 ? bins[(int64_t)prm[s[i] * kParamCols + 1] * ld + r]
                      : 0;
    cnt_nz[i] = s[i] >= 0 && gh[2 * ld + r] != 0;
  }
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int r = r0 + i * kPartThreads + threadIdx.x;
    kept[i] = -1;
    if (r >= N) continue;
    if (s[i] < 0) {
      pleaf_new[r] = p[i];
      continue;
    }
    const int* q = prm + s[i] * kParamCols;
    int b = fb[i];
    const int mfb = q[8];
    if (mfb >= 0) {
      const int tt = b - q[7];
      b = (tt >= 0 && tt < q[9]) ? tt + (tt >= mfb ? 1 : 0) : mfb;
    }
    bool go_left;
    if (HasCat && q[10] != 0)
      go_left = b >= 0 && b < Bc
                && ((cbits[s[i] * W + (b >> 5)] >> (b & 31)) & 1u);
    else
      go_left = b <= q[2] || (q[3] != 0 && b == q[4]);
    pleaf_new[r] = go_left ? p[i] : q[6];
    if (go_left == (q[5] != 0) && cnt_nz[i]) {
      kept[i] = s[i];
      atomicAdd(scnt + s[i], 1);
    }
  }
  if constexpr (kF32) {
    const int wi = threadIdx.x >> 5;
    m0 = __reduce_max_sync(0xffffffffu, m0);
    m1 = __reduce_max_sync(0xffffffffu, m1);
    m2 = __reduce_max_sync(0xffffffffu, m2);
    if ((threadIdx.x & 31) == 0) {
      wmax[0][wi] = m0;
      wmax[1][wi] = m1;
      wmax[2][wi] = m2;
    }
  }
  __syncthreads();
  if constexpr (kF32) {
    if (threadIdx.x < 3) {
      unsigned x = 0;
      for (int i = 0; i < kPartThreads / 32; ++i)
        x = max(x, wmax[threadIdx.x][i]);
      w.parts[3 * blockIdx.x + threadIdx.x] = x;
    }
  }
  block_exclusive_scan(scnt, S, soff);
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int c = scnt[s];
    w.cnt[(int64_t)s * NB + blockIdx.x] = c;
    w.seg[(int64_t)s * NB + blockIdx.x] = r0 + soff[s];
    if (c != 0) atomicAdd(w.tot + s, c);
  }
  __syncthreads();
  // the kept rows, grouped by slot: one shared atomic per slot and warp
  const unsigned lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kPartRowsPerThread; ++i) {
    const int s = kept[i];
    const unsigned peers = __match_any_sync(0xffffffffu, s);
    if (s >= 0) {
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if ((int)lane == leader) base = atomicAdd(soff + s, __popc(peers));
      base = __shfl_sync(peers, base, leader);
      w.list[r0 + base + __popc(peers & ((1u << lane) - 1u))] =
          r0 + i * kPartThreads + threadIdx.x;
    }
  }

  // the last block to finish builds the histogram launch's work list
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(w.done_part, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int t = atomicExch(w.tot + s, 0);
    const int n = max(1, min(slot_items, t / chunk + (t % chunk != 0)));
    w.rows_of[s] = t;
    w.items_of[s] = n;
    w.chunk_of[s] = max(1, t / n + (t % n != 0));
    scnt[s] = n;
  }
  __syncthreads();
  block_exclusive_scan(scnt, S, soff);
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    for (int j = 0; j < scnt[s]; ++j) {
      w.item_slot[soff[s] + j] = s;
      w.item_chunk[soff[s] + j] = j;
    }
  if (threadIdx.x == 0) {
    *w.n_items = soff[S];
    *w.done_part = 0;
  }
  if constexpr (kF32) {
    if (threadIdx.x < 32) {
      unsigned x0 = 0, x1 = 0, x2 = 0;
      for (int b = lane; b < NB; b += 32) {
        x0 = max(x0, __ldcg(w.parts + 3 * b));
        x1 = max(x1, __ldcg(w.parts + 3 * b + 1));
        x2 = max(x2, __ldcg(w.parts + 3 * b + 2));
      }
      x0 = __reduce_max_sync(0xffffffffu, x0);
      x1 = __reduce_max_sync(0xffffffffu, x1);
      x2 = __reduce_max_sync(0xffffffffu, x2);
      if (lane == 0) {
        w.exps[0] = fx_exponent(x0, log2_rows);
        w.exps[1] = fx_exponent(x1, log2_rows);
        w.exps[2] = fx_exponent(x2, log2_rows);
      }
    }
  }
}

__device__ __forceinline__ float cell_to_f32(int v, int) { return (float)v; }

__device__ __forceinline__ float cell_to_f32(fx_t v, int k) {
  return (float)ldexp((double)(long long)v, -k);
}

// The f32 mode's int64 cells and values take about twice the registers:
// uncapped, 104 a thread and 2 blocks a SM; capped at 64, 4 blocks a SM
// and no spills (PERF.md).
template <typename Val, typename Acc>
__global__ void __launch_bounds__(kRoundHistThreads,
                                  std::is_same<Val, float>::value ? 4 : 1)
    round_hist_kernel(
    const int32_t* __restrict__ bins, const Val* __restrict__ gh,
    RoundBufs w, Acc* __restrict__ acc, float* __restrict__ out, int G,
    int N, int Bc, int NB, int Gc) {
  const int item = blockIdx.x;
  if (item >= *w.n_items) return;  // past the work list
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* tile = reinterpret_cast<Acc*>(smem);  // (3, Gc, Bc)
  int* P = reinterpret_cast<int*>(tile + 3 * Gc * Bc);  // (NB + 1,)
  int* SG = P + NB + 1;                                 // (NB,)
  __shared__ bool last;
  const int s = w.item_slot[item];
  const int T = w.rows_of[s], nch = w.items_of[s], cs = w.chunk_of[s];
  const int p0 = w.item_chunk[item] * cs, p1 = min(T, p0 + cs);
  const int g0 = blockIdx.y * Gc, gn = min(Gc, G - g0);
  const int64_t ld = N;
  for (int i = threadIdx.x; i < 3 * Gc * Bc; i += blockDim.x) tile[i] = 0;
  if (p1 > p0) {  // the slot's rows: per partition block, their count and
                  // where they start in the list
    block_exclusive_scan(w.cnt + (int64_t)s * NB, NB, P);
    for (int b = threadIdx.x; b < NB; b += blockDim.x)
      SG[b] = w.seg[(int64_t)s * NB + b];
  }
  int k[3] = {0, 0, 0};
  if constexpr (std::is_same<Val, float>::value)
    for (int c = 0; c < 3; ++c) k[c] = w.exps[c];
  __syncthreads();
  // kU positions a thread at a time, every load issued before any add
  for (int p = p0 + threadIdx.x; p < p1; p += kU * blockDim.x) {
    int r[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int pu = p + u * blockDim.x;
      r[u] = -1;
      if (pu < p1) {
        int lo = 0, hi = NB;  // P[lo] <= pu < P[hi]
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (P[mid] <= pu) lo = mid;
          else hi = mid;
        }
        r[u] = w.list[SG[lo] + (pu - P[lo])];
      }
    }
    Acc v[kU][3];
    int b[kU][kRoundMaxCols];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (r[u] < 0) continue;
      load_vals(gh, ld, r[u], k, v[u][0], v[u][1], v[u][2]);
#pragma unroll
      for (int gl = 0; gl < kRoundMaxCols; ++gl)
        b[u][gl] = gl < gn ? __ldg(bins + (int64_t)(g0 + gl) * ld + r[u]) : -1;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (r[u] < 0) continue;
#pragma unroll
      for (int gl = 0; gl < kRoundMaxCols; ++gl) {
        const int bb = b[u][gl];
        if (bb < 0 || bb >= Bc) continue;  // no bin, as a one-hot would
        Acc* cell = tile + gl * Bc + bb;
        if (v[u][0]) atomicAdd(cell, v[u][0]);
        if (v[u][1]) atomicAdd(cell + Gc * Bc, v[u][1]);
        if (v[u][2]) atomicAdd(cell + 2 * Gc * Bc, v[u][2]);
      }
    }
  }
  __syncthreads();
  const int cc = gn * Bc;  // cells per channel of this column group
  const int64_t base = ((int64_t)s * 3 * G + g0) * Bc;
  if (nch == 1) {  // the slot's only item: the whole tile, as f32
    for (int i = threadIdx.x; i < 3 * cc; i += blockDim.x) {
      const int c = i / cc, x = i - c * cc;
      out[base + (int64_t)c * G * Bc + x] = cell_to_f32(tile[c * Gc * Bc + x],
                                                        k[c]);
    }
    return;
  }
  for (int i = threadIdx.x; i < 3 * cc; i += blockDim.x) {
    const int c = i / cc, x = i - c * cc;
    const Acc v = tile[c * Gc * Bc + x];
    if (v) atomicAdd(acc + base + (int64_t)c * G * Bc + x, v);
  }
  __threadfence();
  __syncthreads();
  int* done = w.done_hist + s * gridDim.y + blockIdx.y;
  if (threadIdx.x == 0) last = atomicAdd(done, 1) == nch - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < 3 * cc; i += blockDim.x) {
    const int c = i / cc;
    const int64_t o = base + (int64_t)c * G * Bc + (i - c * cc);
    out[o] = cell_to_f32(atomicExch(acc + o, (Acc)0), k[c]);
  }
  if (threadIdx.x == 0) *done = 0;
}

// The scratch layout (the wrapper sizes it: cuda_hist.hist_round_plan):
//   state, zeroed once and left zeroed by every call: the partition's
//     counter, tot (S), done_hist (S x n_cg);
//   work: n_items, exps (3), rows_of, items_of and chunk_of (S each),
//     item_slot and item_chunk
//     (max_items each), cnt and seg (S x NB each), parts (3 x NB).
RoundBufs round_bufs(void* state, void* work, void* list, int S, int NB,
                     int max_items) {
  RoundBufs w;
  int* st = (int*)state;
  int* wk = (int*)work;
  w.done_part = st;
  w.tot = st + 1;
  w.done_hist = st + 1 + S;
  w.n_items = wk;
  w.exps = wk + 1;
  w.rows_of = wk + 4;
  w.items_of = w.rows_of + S;
  w.chunk_of = w.items_of + S;
  w.item_slot = w.chunk_of + S;
  w.item_chunk = w.item_slot + max_items;
  w.cnt = w.item_chunk + max_items;
  w.seg = w.cnt + (int64_t)S * NB;
  w.parts = (unsigned*)(w.seg + (int64_t)S * NB);
  w.list = (int*)list;
  return w;
}

template <typename Val, typename Acc, bool HasCat>
int launch_round(const void* bins, const void* gh, const void* pleaf,
                 const void* params, const void* cat_mask, RoundBufs w,
                 void* acc, void* out, void* pleaf_new, int G, int N, int S,
                 int Bc, int L, int NB, int chunk, int slot_items, int Gc,
                 int n_cg, int max_items, int log2_rows, cudaStream_t st) {
  const int smem1 = ((L + 1) + S * kParamCols + S + (S + 1)
                     + (HasCat ? S * cat_words(Bc) : 0)) * (int)sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      round_partition_kernel<Val, HasCat>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (e != cudaSuccess) return (int)e;
  round_partition_kernel<Val, HasCat><<<NB, kPartThreads, smem1, st>>>(
      (const int32_t*)bins, (const Val*)gh, (const int32_t*)pleaf,
      (const int32_t*)params, (const bool*)cat_mask, (int32_t*)pleaf_new, w,
      N, S, Bc, L, NB, chunk, slot_items, log2_rows);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int smem2 = 3 * Gc * Bc * (int)sizeof(Acc)
                    + (2 * NB + 1) * (int)sizeof(int);
  e = cudaFuncSetAttribute(round_hist_kernel<Val, Acc>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (e != cudaSuccess) return (int)e;
  round_hist_kernel<Val, Acc>
      <<<dim3(max_items, n_cg), kRoundHistThreads, smem2, st>>>(
      (const int32_t*)bins, (const Val*)gh, w, (Acc*)acc, (float*)out, G, N,
      Bc, NB, Gc);
  return (int)cudaGetLastError();
}

template <typename Val, typename Acc>
int launch_round_mode(const void* cat_mask, const void* bins, const void* gh,
                      const void* pleaf, const void* params, RoundBufs w,
                      void* acc, void* out, void* pleaf_new, int G, int N,
                      int S, int Bc, int L, int NB, int chunk,
                      int slot_items, int Gc, int n_cg, int max_items,
                      int log2_rows, cudaStream_t st) {
  if (cat_mask != nullptr)
    return launch_round<Val, Acc, true>(
        bins, gh, pleaf, params, cat_mask, w, acc, out, pleaf_new, G, N, S,
        Bc, L, NB, chunk, slot_items, Gc, n_cg, max_items, log2_rows, st);
  return launch_round<Val, Acc, false>(
      bins, gh, pleaf, params, nullptr, w, acc, out, pleaf_new, G, N, S, Bc,
      L, NB, chunk, slot_items, Gc, n_cg, max_items, log2_rows, st);
}

}  // namespace lgbm_torch

// mode 0: gh (3, N) int32 levels (int16 mode); 1: int8 levels; 2: f32
// values (fixed point, log2_rows = ceil(log2 N)). cat_mask: (S, Bc) bool
// category sets (bin b of slot s goes left), or null when no slot can be
// categorical. state, work, list, acc: the scratch above (acc: S x 3 x G x
// Bc cells, int32 in the integer modes, int64 in the f32 mode; state and
// acc zeroed). out (S, 3, G, Bc) f32 and pleaf_new (N,): written whole.
// NB = ceil(N / 2048) partition blocks, N >= 1.
extern "C" int lgbm_hist_round(int mode, const void* bins, const void* gh,
                               const void* pleaf, const void* params,
                               const void* cat_mask, void* state, void* work,
                               void* list, void* acc, void* out,
                               void* pleaf_new, int G, int N, int S, int Bc,
                               int L, int NB, int chunk, int slot_items,
                               int Gc, int n_cg, int max_items,
                               int log2_rows, void* stream) {
  using namespace lgbm_torch;
  if (NB != (N + kPartRows - 1) / kPartRows || chunk < 1 || slot_items < 1
      || Gc < 1
      || Gc > kRoundMaxCols || n_cg * Gc < G)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const RoundBufs w = round_bufs(state, work, list, S, NB, max_items);
  if (mode == 0)
    return launch_round_mode<int32_t, int>(
        cat_mask, bins, gh, pleaf, params, w, acc, out, pleaf_new, G, N, S,
        Bc, L, NB, chunk, slot_items, Gc, n_cg, max_items, log2_rows, st);
  if (mode == 1)
    return launch_round_mode<int8_t, int>(
        cat_mask, bins, gh, pleaf, params, w, acc, out, pleaf_new, G, N, S,
        Bc, L, NB, chunk, slot_items, Gc, n_cg, max_items, log2_rows, st);
  if (mode == 2)
    return launch_round_mode<float, fx_t>(
        cat_mask, bins, gh, pleaf, params, w, acc, out, pleaf_new, G, N, S,
        Bc, L, NB, chunk, slot_items, Gc, n_cg, max_items, log2_rows, st);
  return (int)cudaErrorInvalidValue;
}
