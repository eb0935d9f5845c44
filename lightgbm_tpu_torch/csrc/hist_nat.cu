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
// matrix unit; Hopper has shared-memory atomics, so every mode scatters
// each row straight into its sums instead (no one-hot).
#include <algorithm>

#include <cooperative_groups.h>

#include "hist_common.cuh"

// ------------------------------------------------------------ integer modes
//
// The training path launches them once a tree, at the root: S = 1, every
// row in the slot, G = 28 columns, Bc = 256 bins, N = 1,001,472 rows.
//
// What bounds them on the H100: device-memory bytes. Each row's G bins,
// its slot and its three levels are read once: N x 4 x (G + 4) = 128 MB
// at the root (int8 levels: N x (4 x G + 4 + 3) = 119 MB), 38 / 36 us at
// 3.35 TB/s. Behind them, 3 shared-memory atomics a row and column (84M
// at the root), which run at full rate only if a warp's 32 lanes hit 32
// different banks, and the combination of the blocks' partial tiles.
//
// What the design does about it:
//   - Lanes are columns, not rows. A warp takes 4 rows at a time, each
//     lane one column of the tile's group (W columns a replica, a power of
//     two; with fewer columns than 32 the lanes split into 32 / W
//     replicas, each on its own rows). The rows' slots and levels are the
//     same addresses for every lane of a replica: read once for all of
//     the group's columns.
//   - Each lane owns one of P positions of every (slot, channel, bin)
//     cell: the tile is (Sc, 3, Bc, P) int32 in shared memory, position p
//     in bank p, so a warp's atomics never collide in a bank whatever the
//     bins (a row-per-lane tile puts the lanes' random bins in about
//     3.5-way bank conflicts). Lanes p and p + P share a position, and so
//     a column, through the atomics.
//   - With 16-byte aligned inputs, N % 16 == 0 and every slot in one tile
//     (the staged path, the root's), the rows come through a ring of
//     shared-memory stages: one thread issues bulk copies (the tensor
//     memory accelerator, one per column, the slots and each channel,
//     `chunk` rows long) that complete on an mbarrier, and the other warps
//     add a stage as soon as it lands, releasing it on a second mbarrier;
//     no block-wide barrier a chunk. Otherwise each lane loads its own 4
//     rows (the direct path: slots spread over slot chunks, where most
//     rows of a chunk fall outside it, or unaligned inputs).
//   - A grid sized to the card (one block of 1024 threads a SM) walks the
//     work items: (slot chunk, column group) tiles, each cut into R row
//     splits of contiguous rows, R = blocks / tiles.
//   - A tile that one item owns (R = 1: many slots) is folded (the
//     positions of a column summed with warp shuffles) and written to the
//     output as f32 with plain stores. Otherwise each item writes its
//     folded int32 partial tile with plain stores, and after a grid-wide
//     barrier (a cooperative launch, so every block is resident) the
//     blocks sum each cell's R partials (16-byte loads from L2) and write
//     the f32 output. One device operation a call: no fill, no conversion
//     launch, no scratch that must be zero.
// The root runs the staged path with a 48 KB tile (P = 16, so W = 16: two
// column groups of 14, the slots and levels read twice, 144 MB) and two
// stages of 1152 rows: 66 row splits a group, 132 blocks.
//
// Variants timed and lost (device ms a call at the root, int16 / int8
// mode; python3 -m lightgbm_tpu_torch.tools.hist_tiling nat on an H100
// 80GB HBM3 at 700 W; the first design, one row a lane and 489 blocks
// flushing 21,504 cells each with global atomics, 0.195 / 0.201):
//   - the direct path for every call (lanes as columns, each lane its own
//     4 rows with 16-byte loads): best 0.093 / 0.085 at 2048 threads a SM
//     and a 48 KB tile; 8 rows a lane: 64 registers, 1024
//     threads a SM, 0.103 / 0.097; 512 or 256 threads a block: 0.117 to
//     0.284;
//   - an int32 accumulator that the last block converts, in place of the
//     partials and the grid barrier: slower at all 16 points timed,
//     0.116 / 0.113 against 0.103 / 0.097 at the 96 KB tile;
//   - stages filled with cp.async by every thread and two block barriers
//     a chunk: best 0.086 / 0.088 (512-row chunks);
//   - the ring with a 96 KB tile (P = 32, one column group, slots and
//     levels read once): 0.079 / 0.084 at two stages of 512 rows (the most
//     that fits beside it), 0.089 / 0.094 at four stages of 256: longer
//     bulk copies beat more in flight and one read of the slots and
//     levels;
//   - 768 or 512 threads a block at the chosen sizes: 0.072-0.076 /
//     0.080-0.086 and 0.088 / 0.099.
// What holds the chosen design at 0.071 / 0.079 against its bound: the
// ring holds one 1152-row chunk in flight a SM beside the one being added
// (the tile and two stages fill 210 KB of the block's 227), and each call
// pays a fixed cost for zeroing and folding the tile, writing and summing
// 132 partial tiles and the grid barrier (the sweep's `fixed` line).
//
// Exactness: every sum is an integer sum, the same in any atomic order.
// No cell can overflow: the wrapper refuses calls whose worst-case cell
// sum, N rows x the levels' bound, reaches 2^31 (check_int_range; 256
// levels in the int16 mode, 127 in the int8 mode), and every partial sum
// is a sum over a subset of those rows; an item holds fewer than 2^23
// rows (cuda_hist.NAT_ITEM_ROWS), so its int32 tile cells stay below 2^31
// at 256 levels whatever the call's row count.

namespace lgbm_torch {

constexpr int kNatMaxThreads = 1024;
constexpr int kNatRows = 4;  // rows a lane a turn

// One call's launch, from the wrapper's plan (cuda_hist.hist_nat_plan).
struct NatArgs {
  const int32_t* bins;
  const void* gh;
  const int32_t* slot;
  float* out;
  int* part;   // partial tiles (items x tcp ints)
  int G, N, S, Bc;
  int P;       // positions a cell: a power of two <= 32
  int W;       // columns a replica: a power of two <= P
  int Gc, Sc;  // columns and slots of a tile
  int n_cg, tiles, R, rows, items, tcp;
  int chunk, stages;  // rows a staged chunk, chunks in flight (kVec)
};

// Ints of the tile (Sc, 3, Bc, P), rounded up to 16 bytes: the stages
// follow it in shared memory.
__host__ __device__ inline int nat_tile_ints(int Sc, int Bc, int P) {
  return (Sc * 3 * Bc * P + 3) / 4 * 4;
}

// Ints of one stage of `chunk` rows: gc columns of bins, each padded by 4
// ints so that the lanes' 16-byte reads of 32 columns fall in different
// banks, then the slots, then the three channels (int8 ones packed 4 a
// word).
__host__ __device__ inline int nat_stage_ints(int chunk, int gc, int int8) {
  return gc * (chunk + 4) + chunk + 3 * (int8 ? chunk / 4 : chunk);
}

constexpr int kNatMaxStages = 8;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

// One arrival on bar that also expects `bytes` of copies to complete on it.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait for the phase of parity `parity` of bar to complete. A wait that
// cannot end (a fault in the copies' accounting) traps after ~seconds
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (unsigned spins = 0;; ++spins) {
    unsigned ok;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (ok) return;
    if (spins > (1u << 24)) __trap();
  }
}

// A bulk copy (the tensor memory accelerator) of `bytes` (a multiple of
// 16, both addresses 16-byte aligned) from device to shared memory,
// completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Rows [r, r + rk) (rk a multiple of 16) of the tile's gn columns, the
// slots and the three channels into stage st: gn + 4 bulk copies, issued
// by one thread, completing on `full`.
template <typename Val>
__device__ __forceinline__ void nat_issue(const NatArgs& a, int* st,
                                          uint64_t* full, int g0, int gn,
                                          int r, int rk) {
  const int64_t ld = a.N;
  const unsigned b32 = 4u * rk, bv = (unsigned)sizeof(Val) * rk;
  mbar_expect_tx(full, (gn + 1) * b32 + 3 * bv);
  for (int g = 0; g < gn; ++g)
    bulk_copy(st + g * (a.chunk + 4), a.bins + (g0 + g) * ld + r, b32, full);
  int* sl = st + a.Gc * (a.chunk + 4);
  bulk_copy(sl, a.slot + r, b32, full);
  const int ch_ints = a.chunk * (int)sizeof(Val) / 4;
  for (int c = 0; c < 3; ++c)
    bulk_copy(sl + a.chunk + c * ch_ints,
              static_cast<const Val*>(a.gh) + c * ld + r, bv, full);
}

// Row t of the 4 a lane reads from a word of 4 packed int8 values.
__device__ __forceinline__ int nat_byte(int w, int t) {
  return (int)(int8_t)(w >> (8 * t));
}

// Channel c's 4 values of rows [j, j + 4) of a stage (j a multiple of 4).
__device__ __forceinline__ void nat_stage_vals(const int* chs, int chunk,
                                               int c, int j, int32_t,
                                               int (&v)[kNatRows]) {
  const int4 x = *reinterpret_cast<const int4*>(chs + c * chunk + j);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void nat_stage_vals(const int* chs, int chunk,
                                               int c, int j, int8_t,
                                               int (&v)[kNatRows]) {
  const int w = chs[c * (chunk / 4) + j / 4];
#pragma unroll
  for (int t = 0; t < kNatRows; ++t) v[t] = nat_byte(w, t);
}

// Rows t of a lane's 4 into its position: cell (slot s[t], bin b[t]) of
// each channel whose value is not zero.
__device__ __forceinline__ void nat_add(int* mine, const int (&s)[kNatRows],
                                        const int (&b)[kNatRows],
                                        const int (&v0)[kNatRows],
                                        const int (&v1)[kNatRows],
                                        const int (&v2)[kNatRows], int sn,
                                        int Bc, int P) {
  const int BcP = Bc * P;
#pragma unroll
  for (int t = 0; t < kNatRows; ++t) {
    // a bin outside [0, Bc) matches no cell, as a one-hot would
    if ((unsigned)s[t] >= (unsigned)sn || (unsigned)b[t] >= (unsigned)Bc)
      continue;
    int* cell = mine + (s[t] * 3 * Bc + b[t]) * P;
    if (v0[t]) atomicAdd(cell, v0[t]);
    if (v1[t]) atomicAdd(cell + BcP, v1[t]);
    if (v2[t]) atomicAdd(cell + 2 * BcP, v2[t]);
  }
}

// A lane's rows [r, r + 4) of a row vector straight from device memory,
// rows at or past r1 giving `fill` (the path without 16-byte alignment).
template <typename T>
__device__ __forceinline__ void nat_load(const T* __restrict__ p, int64_t r,
                                         int64_t r1, int fill,
                                         int (&x)[kNatRows]) {
#pragma unroll
  for (int t = 0; t < kNatRows; ++t)
    x[t] = r + t < r1 ? (int)__ldg(p + r + t) : fill;
}

// out index of folded cell (row = (sl * 3 + c) * Bc + b, column g0 + p) of
// a tile whose slots start at s0.
__device__ __forceinline__ int64_t nat_out_index(const NatArgs& a, int s0,
                                                 int g0, int row, int p) {
  const int b = row % a.Bc, sc3 = row / a.Bc;  // sc3 = sl * 3 + c
  return ((int64_t)(s0 * 3 + sc3) * a.G + g0 + p) * a.Bc + b;
}

// Val: int32_t or int8_t levels, summed in int32 cells. kVec: the rows
// come through shared-memory stages (16-byte copies; N % 16 == 0 and the
// inputs 16-byte aligned); otherwise each lane loads its own.
template <typename Val, bool kVec>
__global__ void __launch_bounds__(kNatMaxThreads) nat_kernel(NatArgs a) {
  extern __shared__ __align__(16) int nat_smem[];
  int* tile = nat_smem;  // (sn, 3, Bc, P) this item's positions
  int* stage0 = nat_smem + nat_tile_ints(a.Sc, a.Bc, a.P);
  const int st_ints = nat_stage_ints(a.chunk, a.Gc, sizeof(Val) == 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int P = a.P, W = a.W, Bc = a.Bc;
  const int gl = lane & (W - 1);  // the lane's column in its group
  const int step = kNatRows * (32 / W);  // rows of a warp's turn
  const int rep_row = (lane / W) * kNatRows;  // its replica's first row
  const int64_t ld = a.N;
  int* mine = tile + (lane & (P - 1));  // the lane's position
  // the stages' barriers: full[s] completes when stage s's copies land,
  // empty[s] when every consumer warp has read it
  __shared__ __align__(8) uint64_t full[kNatMaxStages], empty[kNatMaxStages];
  int kk = 0;
  if (kVec && threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, nwarps - 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int t_ = item / a.R, r_ = item - t_ * a.R;
    const int sc = t_ / a.n_cg, cg = t_ - sc * a.n_cg;
    const int s0 = sc * a.Sc, sn = min(a.Sc, a.S - s0);
    const int g0 = cg * a.Gc, gn = min(a.Gc, a.G - g0);
    const int r0 = r_ * a.rows, r1 = min(a.N, r0 + a.rows);
    const int cells = sn * 3 * Bc * P;
    const bool col = gl < gn;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) tile[i] = 0;
    if (kVec) {
      // chunks of the item's rows through a ring of D stages: warp 0's
      // first lane copies chunk k into stage k % D once the consumers
      // (the other warps) have released it, and they add each chunk as
      // soon as its copies complete; kk counts the block's chunks over
      // its items, so every stage's phases follow from it
      const int D = a.stages, C = a.chunk;
      const int nch = (r1 - r0 + C - 1) / C;
      // the first D chunks go out while the tile is zeroed: every stage
      // is free at an item's start (the last item's chunks are added)
      if (threadIdx.x == 0)
        for (int k = 0; k < min(D, nch); ++k)
          nat_issue<Val>(a, stage0 + (kk + k) % D * st_ints,
                         full + (kk + k) % D, g0, gn, r0 + k * C,
                         min(C, r1 - r0 - k * C));
      __syncthreads();  // the tile is zeroed
      if (warp == 0) {
        if (lane == 0)
          for (int k = D; k < nch; ++k) {
            const int q = kk + k, sidx = q % D;
            mbar_wait(empty + sidx, (q / D - 1) & 1);
            nat_issue<Val>(a, stage0 + sidx * st_ints, full + sidx, g0, gn,
                           r0 + k * C, min(C, r1 - r0 - k * C));
          }
      } else {
        const int cw = warp - 1, ncw = nwarps - 1;
        for (int k = 0; k < nch; ++k) {
          const int q = kk + k, sidx = q % D;
          mbar_wait(full + sidx, (q / D) & 1);
          const int* st = stage0 + sidx * st_ints;
          const int* sl = st + a.Gc * (C + 4);
          const int* chs = sl + C;
          const int rk = min(C, r1 - r0 - k * C);
          for (int jb = cw * step; jb < rk; jb += ncw * step) {
            const int j = jb + rep_row;
            if (j >= rk) continue;
            const int4 sv = *reinterpret_cast<const int4*>(sl + j);
            const int s[kNatRows] = {sv.x - s0, sv.y - s0, sv.z - s0,
                                     sv.w - s0};
            bool any = false;
#pragma unroll
            for (int t = 0; t < kNatRows; ++t)
              any |= (unsigned)s[t] < (unsigned)sn;
            if (!any || !col) continue;
            int v0[kNatRows], v1[kNatRows], v2[kNatRows];
            nat_stage_vals(chs, C, 0, j, Val(), v0);
            nat_stage_vals(chs, C, 1, j, Val(), v1);
            nat_stage_vals(chs, C, 2, j, Val(), v2);
            const int4 bv =
                *reinterpret_cast<const int4*>(st + gl * (C + 4) + j);
            const int b[kNatRows] = {bv.x, bv.y, bv.z, bv.w};
            nat_add(mine, s, b, v0, v1, v2, sn, Bc, P);
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + sidx);  // stage read
        }
      }
      kk += nch;
      __syncthreads();  // every chunk is added
    } else {
      __syncthreads();
      const Val* gh = static_cast<const Val*>(a.gh);
      const int32_t* bcol = a.bins + (int64_t)(g0 + (col ? gl : 0)) * ld;
      for (int rb = r0 + warp * step; rb < r1; rb += nwarps * step) {
        const int rr = rb + rep_row;  // rows [rr, rr + 4) of this lane
        int s[kNatRows];
        nat_load(a.slot, rr, r1, -1, s);
        bool any = false;
#pragma unroll
        for (int t = 0; t < kNatRows; ++t) {
          s[t] -= s0;  // the slot in the tile; the trash slot fails
          any |= (unsigned)s[t] < (unsigned)sn;
        }
        if (!any || !col) continue;
        int v0[kNatRows], v1[kNatRows], v2[kNatRows], b[kNatRows];
        nat_load(gh, rr, r1, 0, v0);
        nat_load(gh + ld, rr, r1, 0, v1);
        nat_load(gh + 2 * ld, rr, r1, 0, v2);
        nat_load(bcol, rr, r1, -1, b);
        nat_add(mine, s, b, v0, v1, v2, sn, Bc, P);
      }
      __syncthreads();
    }
    // fold: a warp reads 32 consecutive positions and sums each column's
    // replicas (lanes p, p + W, ... of a cell) with shuffles; lane p < gn
    // then holds cell (row, column g0 + p)
    for (int f0 = warp * 32; f0 < cells; f0 += nwarps * 32) {
      const int f = f0 + lane;
      int v = f < cells ? tile[f] : 0;
      for (int o = W; o < P; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      const int p = f & (P - 1), row = f / P;
      if (f >= cells || p >= gn) continue;
      if (a.R == 1)
        a.out[nat_out_index(a, s0, g0, row, p)] = (float)v;
      else
        a.part[(int64_t)item * a.tcp + row * a.Gc + p] = v;
    }
    __syncthreads();  // the tile is zeroed for the next item
  }
  if (a.R == 1) return;
  // every partial is written: each block sums chunks of 128 cells of a
  // tile, its warps splitting the R partials (a 16-byte load of 4 cells a
  // lane), then 128 threads add the warps' sums and write the f32 output
  cooperative_groups::this_grid().sync();
  int* red = nat_smem;  // (nwarps, 128)
  const int tc = a.Sc * 3 * Bc * a.Gc;
  const int chunks = (tc + 127) / 128;
  for (int task = blockIdx.x; task < a.tiles * chunks; task += gridDim.x) {
    const int t_ = task / chunks, l0 = (task - t_ * chunks) * 128;
    int4 acc = make_int4(0, 0, 0, 0);
    if (l0 + lane * 4 < a.tcp) {
      const int* src = a.part + (int64_t)t_ * a.R * a.tcp + l0 + lane * 4;
      for (int r = warp; r < a.R; r += nwarps) {
        const int4 x =
            __ldcg(reinterpret_cast<const int4*>(src + (int64_t)r * a.tcp));
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
    }
    reinterpret_cast<int4*>(red)[warp * 32 + lane] = acc;
    __syncthreads();
    const int l = l0 + threadIdx.x;
    if (threadIdx.x < 128 && l < tc) {
      const int sc = t_ / a.n_cg, cg = t_ - sc * a.n_cg;
      const int s0 = sc * a.Sc, sn = min(a.Sc, a.S - s0);
      const int g0 = cg * a.Gc, gn = min(a.Gc, a.G - g0);
      const int p = l % a.Gc, row = l / a.Gc;
      if (p < gn && row < sn * 3 * Bc) {
        int sum = 0;
        for (int w = 0; w < nwarps; ++w) sum += red[w * 128 + threadIdx.x];
        a.out[nat_out_index(a, s0, g0, row, p)] = (float)sum;
      }
    }
    __syncthreads();
  }
}

typedef void (*NatKernel)(NatArgs);

NatKernel nat_pick(int int8, int vec) {
  if (int8) return vec ? nat_kernel<int8_t, true> : nat_kernel<int8_t, false>;
  return vec ? nat_kernel<int32_t, true> : nat_kernel<int32_t, false>;
}

}  // namespace lgbm_torch

// Integer modes: bins (G, N) int32; gh (3, N) int32 levels (int8 = 0, the
// int16 mode) or int8 levels (int8 = 1); slot (N,) int32 in [0, S]; out
// (S, 3, G, Bc) f32, written whole; N >= 1. The plan (cuda_hist.
// hist_nat_plan): P positions a cell, W columns a replica, Gc columns and
// Sc slots a tile, n_cg column groups, R row splits of `rows` rows each
// (a multiple of 32), grid blocks of `threads`, `smem` bytes of dynamic
// shared memory (the tile, then `stages` stages of `chunk` rows), vec (the
// staged path: N % 16 == 0 and bins, gh, slot 16-byte aligned; chunk a
// multiple of 32, stages 2 to 8). part: R > 1: tiles x R x tcp ints, tcp
// = Sc x 3 x Bc x Gc rounded up to a multiple of 4.
extern "C" int lgbm_hist_nat(int int8, const void* bins, const void* gh,
                             const void* slot, void* out, void* part, int G,
                             int N, int S, int Bc, int P, int W, int Gc,
                             int Sc, int n_cg, int R, int rows, int grid,
                             int threads, int smem, int chunk, int stages,
                             int vec, void* stream) {
  using namespace lgbm_torch;
  const bool pow2 = P >= 1 && P <= 32 && (P & (P - 1)) == 0 && W >= 1
                    && W <= P && (W & (W - 1)) == 0;
  const int64_t need =
      4 * ((int64_t)nat_tile_ints(Sc, Bc, P)
           + (vec ? (int64_t)stages * nat_stage_ints(chunk, Gc, int8) : 0));
  if (!pow2 || G < 1 || N < 1 || S < 1 || Bc < 1 || Gc < 1 || Gc > W
      || n_cg * Gc < G || Sc < 1 || R < 1 || rows < 1 || rows % 32
      || (int64_t)rows * R < N || grid < 1 || threads < 128
      || threads > kNatMaxThreads || threads % 32 || need > smem
      || threads / 32 * 512 > smem || (R > 1 && part == nullptr)
      || (vec && (N % 16 || chunk < 32 || chunk % 32 || stages < 2
                  || stages > kNatMaxStages)))
    return (int)cudaErrorInvalidValue;
  NatArgs a;
  a.bins = (const int32_t*)bins;
  a.gh = gh;
  a.slot = (const int32_t*)slot;
  a.out = (float*)out;
  a.part = (int*)part;
  a.G = G;
  a.N = N;
  a.S = S;
  a.Bc = Bc;
  a.P = P;
  a.W = W;
  a.Gc = Gc;
  a.Sc = Sc;
  a.n_cg = n_cg;
  a.tiles = (S + Sc - 1) / Sc * n_cg;
  a.R = R;
  a.rows = rows;
  a.items = a.tiles * R;
  a.tcp = (Sc * 3 * Bc * Gc + 3) / 4 * 4;
  a.chunk = chunk;
  a.stages = stages;
  const NatKernel fn = nat_pick(int8, vec);
  int err = allow_smem((const void*)fn, smem);
  if (err) return err;
  // a grid-wide barrier needs every block resident: a cooperative launch,
  // which the runtime refuses (cudaErrorCooperativeLaunchTooLarge) rather
  // than run a grid larger than the card holds
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = R > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fn, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// ---------------------------------------------------------------- f32 mode
//
// The refit's shape is one column, S = num_leaves leaf slots and Bc = 256
// bins over ~1M rows: at S = 255 an (S, 3, 1, Bc) int64 tile of ~1.5 MB,
// which no block's shared memory holds. A shared-memory tile cut into
// slot chunks would have each block zero and scan its cells for the few
// of its rows that fall in its chunk. Here instead:
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
//      serves every S: at S = 31, where a shared tile (the integer
//      modes' first design) fits one block, that tile took 0.091 ms on a
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
