// hist and hist_slots: f32 gradient histograms over contiguous row
// segments, one kernel pair for both entry points.
//
// Replaces two TPU kernels of lightgbm_tpu/learner/pallas_hist.py:
//   - hist_tpu (_hist_kernel): one histogram over rows [begin, begin +
//     count) of the exact grower's leaf-grouped matrix: the root, or the
//     smaller child of a sequential split, whose bounds the grower keeps
//     on the device (entry point lgbm_hist, the one-slot case);
//   - hist_slots_tpu (_hist_slots_kernel): per-slot histograms over S
//     disjoint segments [begin_s, begin_s + count_s), the smaller
//     children of one round of the exact grower's round phase
//     (lgbm_hist_slots).
// The TPU kernels contract a one-hot tile per row block on the matrix
// unit and carry each histogram across a sequential grid, on (8, N) hi/lo
// bf16 channels. Here the channels are (3, N) f32 (gradient, hessian,
// in-bag count) summed as int64 fixed point (hist_common.cuh): exact
// integer sums in any order, so the output is the plain versions' bits
// (learner/histogram.py histogram_plain, hist_slots_plain) on every run.
//
// Two launches a call on the caller's stream; no host read, no fill:
// 1. Plan (seg_plan_kernel). Its blocks take the channel maxima over the
//    scale's rows (hist: the segment, with n = cap; hist_slots: all N
//    rows, n = N) into scratch with atomicMax. hist's begin and count are
//    read here, from the grower's 0-dim int32 / int64 tensors or from
//    host ints passed by value: no copy to the card. The last block (a
//    counter bumped after a __threadfence) reduces the maxima to the
//    exponents; turns each slot's row count T into max(1, min(slot_items,
//    ceil(T / chunk))) work items of equal rows and writes the work list;
//    and resets the maxima and its counter for the next call.
// 2. Histogram (seg_hist_kernel), a grid of (item bound, column group)
//    blocks sized on the host from a bound on the items; blocks past the
//    work list exit at once. A block reads its item's contiguous rows four
//    at a time (16-byte loads where the matrix allows), quantizes each
//    row's channels once, and adds them into a (3, Gc, Bc) tile of int64
//    sums in shared memory, each kept as three uint32 limbs (see
//    add_limbs): every shared atomic is a native 32-bit add. A slot held
//    by one item writes its tile whole, as f32, with plain stores (an
//    empty slot writes zeros, so the output needs no fill). A slot of
//    several items adds its non-zero cells into an int64 accumulator
//    (L2-resident); the last of its items per column group (a counter
//    bumped after a __threadfence) converts those cells to f32 and zeroes
//    them again.
// The maxima, the counters, the work list and the accumulator live in
// scratch that the wrapper keeps per (device, stream), allocated zeroed
// once and left zeroed by every call (cuda_hist._SEG_SCRATCH; the layout
// in seg_bufs below). A call runs to its end on one stream.
//
// What bounds it: device-memory bytes — each segment row's G bins and its
// 3 channels once per column group (hist_slots' scale reads every row's
// channels) — and, at the grower's segment sizes, the shared-memory
// atomics: up to 9 a row and column (3 limbs of 3 channels; a count of 0
// or 1 takes one). The sizes (rows per item, items per slot, columns per
// block, plan blocks) are the wrapper's (cuda_hist.hist_plan,
// hist_slots_plan).
#include "hist_common.cuh"

namespace lgbm_torch {

constexpr int kSegThreads = 256;  // both launches

// The scratch of one call, carved from the wrapper's buffers (seg_bufs).
struct SegBufs {
  int* done_plan;      // the plan's finished blocks
  unsigned* maxbits;   // (3,) channel maxima |value|, as f32 bits
  int* done_hist;      // (S, column groups) finished items of a slot
  int* n_items;        // items of the histogram launch
  int* exps;           // (3,) fixed-point exponents
  int4* items;         // (max_items,) rows [x, y) of slot z, which has w
                       // items
  // the fixed-point partials of a sharded run (both null otherwise):
  // max_in (3,) channel maxima over every rank, as f32 bits, set the
  // exponents in place of this call's own rows; raw (S, 3, G, Bc) int64
  // takes the sums in place of out's f32
  const unsigned* max_in;
  fx_t* raw;
};

// Where the segments come from: hist's begin and count (a device scalar
// of 4 or 8 bytes, or a host value when the pointer is null; the count
// capped at cap), or hist_slots' (S,) int32 begins and counts.
struct SegSrc {
  const void* begin;
  const void* count;
  long long begin_val, count_val;
  int begin_w, count_w;
  int cap;
  const int32_t* begins;
  const int32_t* counts;
};

__device__ __forceinline__ long long read_scalar(const void* p, int w,
                                                 long long v) {
  if (p == nullptr) return v;
  return w == 8 ? *static_cast<const long long*>(p)
                : (long long)*static_cast<const int32_t*>(p);
}

// Slot s's rows [b, b + T), clamped to [0, N); a begin outside it is an
// empty slot.
__device__ __forceinline__ void seg_of(const SegSrc& src, int s, int N,
                                       int& b, int& T) {
  long long bb, cc;
  if (src.begins != nullptr) {
    bb = src.begins[s];
    cc = src.counts[s];
  } else {
    bb = read_scalar(src.begin, src.begin_w, src.begin_val);
    cc = min(read_scalar(src.count, src.count_w, src.count_val),
             (long long)src.cap);
  }
  if (bb < 0 || bb >= N || cc <= 0) {
    b = 0;
    T = 0;
    return;
  }
  b = (int)bb;
  T = (int)min(cc, (long long)N - bb);
}

// Inclusive prefix sum of x over the block (blockDim.x a multiple of 32);
// *total gets the block's sum. Every thread of the block calls it.
__device__ int block_inclusive_scan(int x, int* total) {
  __shared__ int ws[32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int t = lane < nw ? ws[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    ws[lane] = t;
  }
  __syncthreads();
  if (wid > 0) x += ws[wid - 1];
  *total = ws[nw - 1];
  __syncthreads();  // ws is reused by the next call
  return x;
}

__global__ void __launch_bounds__(kSegThreads) seg_plan_kernel(
    const float* __restrict__ gh, SegSrc src, SegBufs w, int N, int S,
    int chunk, int slot_items, int log2_rows) {
  __shared__ unsigned wmax[3][kSegThreads / 32];
  __shared__ bool last;
  // the histogram launch may start now: it waits for this grid's end
  // (griddepcontrol.wait) before it reads what this grid writes
  asm volatile("griddepcontrol.launch_dependents;");
  int r0 = 0, r1 = N;  // the scale's rows
  if (src.begins == nullptr) {
    int b, T;
    seg_of(src, 0, N, b, T);
    r0 = b;
    r1 = b + T;
  }
  const int64_t ld = N;
  unsigned m0 = 0, m1 = 0, m2 = 0;
  for (int r = r0 + blockIdx.x * blockDim.x + threadIdx.x; r < r1;
       r += gridDim.x * blockDim.x) {
    m0 = max(m0, __float_as_uint(fabsf(gh[r])));
    m1 = max(m1, __float_as_uint(fabsf(gh[ld + r])));
    m2 = max(m2, __float_as_uint(fabsf(gh[2 * ld + r])));
  }
  const int wi = threadIdx.x >> 5;
  m0 = __reduce_max_sync(0xffffffffu, m0);
  m1 = __reduce_max_sync(0xffffffffu, m1);
  m2 = __reduce_max_sync(0xffffffffu, m2);
  if ((threadIdx.x & 31) == 0) {
    wmax[0][wi] = m0;
    wmax[1][wi] = m1;
    wmax[2][wi] = m2;
  }
  __syncthreads();
  unsigned x = 0;
  if (threadIdx.x < 3)
    for (int i = 0; i < kSegThreads / 32; ++i)
      x = max(x, wmax[threadIdx.x][i]);
  if (gridDim.x > 1) {  // the last block to finish goes on
    if (threadIdx.x < 3 && x != 0) atomicMax(w.maxbits + threadIdx.x, x);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(w.done_plan, 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (threadIdx.x < 3) x = atomicExch(w.maxbits + threadIdx.x, 0u);
    if (threadIdx.x == 0) *w.done_plan = 0;
  }
  if (threadIdx.x < 3)
    w.exps[threadIdx.x] = fx_exponent(
        w.max_in != nullptr ? w.max_in[threadIdx.x] : x, log2_rows);
  // the work list, blockDim.x slots at a time
  int base = 0;
  for (int s0 = 0; s0 < S; s0 += blockDim.x) {
    const int s = s0 + threadIdx.x;
    int n = 0, b = 0, T = 0;
    if (s < S) {
      seg_of(src, s, N, b, T);
      n = max(1, min(slot_items, T / chunk + (T % chunk != 0)));
    }
    int total;
    const int end = base + block_inclusive_scan(n, &total);
    const int cs = max(1, T / max(n, 1) + (T % max(n, 1) != 0));
    for (int j = 0; j < n; ++j) {  // the last item: the rest (maybe none)
      const int r0 = b + min(T, j * cs);
      w.items[end - n + j] = make_int4(r0, b + min(T, (j + 1) * cs), s, n);
    }
    base += total;
  }
  if (threadIdx.x == 0) *w.n_items = base;
}

// 2^k as a double, for |k| <= 1022: multiplying by it is ldexp (exact
// for the fixed point's values, hist_common.cuh) at one instruction.
__device__ __forceinline__ double pow2(int k) {
  return __longlong_as_double((long long)(1023 + k) << 52);
}

// Channel c's scale, without a local array.
__device__ __forceinline__ double scale_of(double3 k, int c) {
  return c == 0 ? k.x : c == 1 ? k.y : k.z;
}

// The tile's cells are int64 sums kept as three uint32 limbs, so that
// every shared-memory atomic is a native 32-bit add (a 64-bit add is a
// compare-and-swap loop on sm_90, which collides when a leaf's rows share
// a bin). Fixed-point value q (two's complement, mod 2^64) = hi * 2^32 +
// mid * 2^16 + lo with mid, lo < 2^16: the lo and mid sums stay exact in
// 32 bits for up to 65537 rows a cell, and the hi sum is needed only mod
// 2^32, since the cell's true sum fits in 63 bits (hist_common.cuh). So
// an item holds at most 65536 rows (cuda_hist.SEG_ITEM_ROWS).
// Limb l of channel c, cell x: tile[(3 * c + l) * cpc + x].
__device__ __forceinline__ void add_limbs(unsigned* p, int cpc, fx_t q) {
  const unsigned lo = (unsigned)q & 0xffffu, mid = (unsigned)q >> 16;
  const unsigned hi = (unsigned)(q >> 32);
  if (lo) atomicAdd(p, lo);
  if (mid) atomicAdd(p + cpc, mid);
  if (hi) atomicAdd(p + 2 * cpc, hi);
}

__device__ __forceinline__ fx_t limb_sum(const unsigned* p, int cpc) {
  return ((fx_t)p[2 * cpc] << 32) + ((fx_t)p[cpc] << 16) + (fx_t)p[0];
}

// Rows [r0, r1) into the tile, four consecutive rows a thread (the groups
// of four aligned to the matrix; kVec: 16-byte loads, which needs N % 4 ==
// 0 and aligned bins and gh).
template <bool kVec>
__device__ __forceinline__ void seg_accumulate(
    const int32_t* __restrict__ bins, const float* __restrict__ gh,
    int64_t ld, int r0, int r1, int g0, int gn, int Bc, int cpc,
    double3 up, unsigned* tile) {
  const int q1 = (r1 + 3) >> 2;
  for (int q = (r0 >> 2) + threadIdx.x; q < q1; q += blockDim.x) {
    const int rb = q << 2;
    bool in[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) in[t] = rb + t >= r0 && rb + t < r1;
    fx_t v[3][4];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* ch = gh + c * ld;
      float f[4];
      if (kVec) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(ch + rb));
        f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) f[t] = in[t] ? __ldg(ch + rb + t) : 0.0f;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
        v[c][t] = in[t] ? (fx_t)__double2ll_rn((double)f[t] * scale_of(up, c))
                        : 0;
    }
    for (int gl = 0; gl < gn; ++gl) {
      const int32_t* bg = bins + (int64_t)(g0 + gl) * ld;
      int b[4];
      if (kVec) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(bg + rb));
        b[0] = x.x; b[1] = x.y; b[2] = x.z; b[3] = x.w;
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) b[t] = in[t] ? __ldg(bg + rb + t) : -1;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        // a bin outside [0, Bc) matches no cell, as a one-hot would
        if (!in[t] || b[t] < 0 || b[t] >= Bc) continue;
        unsigned* cell = tile + gl * Bc + b[t];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          if (v[c][t]) add_limbs(cell + 3 * c * cpc, cpc, v[c][t]);
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kSegThreads) seg_hist_kernel(
    const int32_t* __restrict__ bins, const float* __restrict__ gh,
    SegBufs w, fx_t* __restrict__ acc, float* __restrict__ out, int G,
    int N, int Bc, int Gc) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* tile = reinterpret_cast<unsigned*>(smem);  // (3, 3, Gc, Bc)
  __shared__ bool last;
  const int cpc = Gc * Bc;  // tile cells per channel and limb
  for (int i = threadIdx.x; i < 9 * cpc; i += blockDim.x) tile[i] = 0;
  // launched early behind the plan (programmatic dependent launch): wait
  // for its grid to end before reading the work list
  asm volatile("griddepcontrol.wait;" ::: "memory");
  // one round of loads: the item count, this block's item, the exponents
  const int n_items = *w.n_items;
  const int4 it = w.items[blockIdx.x];
  const int3 k = make_int3(w.exps[0], w.exps[1], w.exps[2]);
  if ((int)blockIdx.x >= n_items) return;  // past the work list
  // 2^k to quantize, 2^-k to convert back
  const double3 up = make_double3(pow2(k.x), pow2(k.y), pow2(k.z));
  const double3 down = make_double3(pow2(-k.x), pow2(-k.y), pow2(-k.z));
  const int r0 = it.x, r1 = it.y, s = it.z, nit = it.w;
  const int g0 = blockIdx.y * Gc, gn = min(Gc, G - g0);
  __syncthreads();
  seg_accumulate<kVec>(bins, gh, N, r0, r1, g0, gn, Bc, cpc, up, tile);
  __syncthreads();
  // cell x = gl * Bc + b of channel c, over the group's columns
  const int cc = gn * Bc;
  const int64_t base = ((int64_t)s * 3 * G + g0) * Bc;
  if (nit == 1) {  // the slot's only item: the whole tile, as f32
    for (int i = threadIdx.x; i < 3 * cc; i += blockDim.x) {
      const int c = i / cc, x = i - c * cc;
      const fx_t v = limb_sum(tile + 3 * c * cpc + x, cpc);
      if (w.raw != nullptr)
        w.raw[base + (int64_t)c * G * Bc + x] = v;
      else
        out[base + (int64_t)c * G * Bc + x] = (float)(
            (double)(long long)v * scale_of(down, c));
    }
    return;
  }
  for (int i = threadIdx.x; i < 3 * cc; i += blockDim.x) {
    const int c = i / cc, x = i - c * cc;
    const fx_t v = limb_sum(tile + 3 * c * cpc + x, cpc);
    if (v) atomicAdd(acc + base + (int64_t)c * G * Bc + x, v);
  }
  __threadfence();
  __syncthreads();
  int* done = w.done_hist + s * gridDim.y + blockIdx.y;
  if (threadIdx.x == 0) last = atomicAdd(done, 1) == nit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < 3 * cc; i += blockDim.x) {
    const int c = i / cc;
    const int64_t o = base + (int64_t)c * G * Bc + (i - c * cc);
    const fx_t v = atomicExch(acc + o, (fx_t)0);
    if (w.raw != nullptr)
      w.raw[o] = v;
    else
      out[o] = (float)((double)(long long)v * scale_of(down, c));
  }
  if (threadIdx.x == 0) *done = 0;
}

// The scratch layout (the wrapper sizes it: cuda_hist._seg_plan):
//   state, zeroed once and left zeroed by every call: the plan's counter,
//     the maxima (3), done_hist (S x column groups);
//   work: n_items, exps (3), items (max_items int4 records).
SegBufs seg_bufs(void* state, void* work) {
  SegBufs w;
  int* st = static_cast<int*>(state);
  int* wk = static_cast<int*>(work);
  w.done_plan = st;
  w.maxbits = reinterpret_cast<unsigned*>(st + 1);
  w.done_hist = st + 4;
  w.n_items = wk;
  w.exps = wk + 1;
  w.items = reinterpret_cast<int4*>(wk + 4);
  w.max_in = nullptr;
  w.raw = nullptr;
  return w;
}

int launch_seg(const void* bins, const void* gh, const SegSrc& src,
               void* state, void* work, void* acc, void* out, int G, int N,
               int S, int Bc, int chunk, int slot_items, int Gc, int n_cg,
               int max_items, int plan_blocks, int log2_rows, int vec,
               const void* max_in, void* raw, cudaStream_t st) {
  if (N < 1 || S < 1 || chunk < 1 || slot_items < 1 || Gc < 1
      || n_cg * Gc < G || plan_blocks < 1 || max_items < 1)
    return (int)cudaErrorInvalidValue;
  SegBufs w = seg_bufs(state, work);
  w.max_in = static_cast<const unsigned*>(max_in);
  w.raw = static_cast<fx_t*>(raw);
  seg_plan_kernel<<<plan_blocks, kSegThreads, 0, st>>>(
      (const float*)gh, src, w, N, S, chunk, slot_items, log2_rows);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int smem = 9 * Gc * Bc * (int)sizeof(unsigned);
  err = allow_smem(vec ? (const void*)seg_hist_kernel<true>
                       : (const void*)seg_hist_kernel<false>,
                   smem);
  if (err) return err;
  // the histogram blocks may start (and zero their tiles) while the plan
  // runs (programmatic dependent launch)
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(max_items, n_cg);
  cfg.blockDim = dim3(kSegThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, vec ? seg_hist_kernel<true> : seg_hist_kernel<false>,
      (const int32_t*)bins, (const float*)gh, w, (fx_t*)acc, (float*)out, G,
      N, Bc, Gc);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace lgbm_torch

// Common arguments: bins (G, N) int32 and gh (3, N) f32 on the device
// (vec: N % 4 == 0 and both 16-byte aligned); state, work, acc the scratch
// above (acc: S x 3 x G x Bc int64; state and acc zeroed); out (S, 3, G,
// Bc) f32, written whole; log2_rows = ceil(log2 n) of the scale's n;
// max_in and raw: null, or a sharded run's fixed-point partials (SegBufs)

// hist: one slot over rows [begin, begin + min(count, cap)). begin and
// count: device scalars of begin_w / count_w bytes (4 or 8), or null to
// take begin_val / count_val.
extern "C" int lgbm_hist(const void* bins, const void* gh, int N,
                         const void* begin, const void* count,
                         long long begin_val, long long count_val,
                         int begin_w, int count_w, int cap, void* state,
                         void* work, void* acc, void* out, int G, int Bc,
                         int chunk, int slot_items, int Gc, int n_cg,
                         int max_items, int plan_blocks, int log2_rows,
                         int vec, const void* max_in, void* raw,
                         void* stream) {
  using namespace lgbm_torch;
  SegSrc src{begin, count, begin_val, count_val, begin_w, count_w, cap,
             nullptr, nullptr};
  return launch_seg(bins, gh, src, state, work, acc, out, G, N, 1, Bc,
                    chunk, slot_items, Gc, n_cg, max_items, plan_blocks,
                    log2_rows, vec, max_in, raw, (cudaStream_t)stream);
}

// hist_slots: S slots over disjoint segments, begins / counts (S,) int32
// on the device; the scale over all N rows.
extern "C" int lgbm_hist_slots(const void* bins, const void* gh, int N,
                               const void* begins, const void* counts,
                               int S, void* state, void* work, void* acc,
                               void* out, int G, int Bc, int chunk,
                               int slot_items, int Gc, int n_cg,
                               int max_items, int plan_blocks,
                               int log2_rows, int vec, const void* max_in,
                               void* raw, void* stream) {
  using namespace lgbm_torch;
  SegSrc src{nullptr, nullptr, 0, 0, 0, 0, 0,
             static_cast<const int32_t*>(begins),
             static_cast<const int32_t*>(counts)};
  return launch_seg(bins, gh, src, state, work, acc, out, G, N, S, Bc,
                    chunk, slot_items, Gc, n_cg, max_items, plan_blocks,
                    log2_rows, vec, max_in, raw, (cudaStream_t)stream);
}
