// take_small: out[j, r] = tab[j, idx[r]] for j < k, 0 where idx[r] is
// outside [0, L). take_rows: the same gather from a node-major table,
// out[j, r] = tab_rows[idx[r], j].
//
// Both replace the TPU kernel lightgbm_tpu/learner/pallas_hist.py
// take_small_tpu (_take_kernel). The TPU has no vector gather, so it
// multiplies the table by a one-hot tile on the matrix unit; Hopper
// gathers directly. The result is exact f32: a copy.
//
// take_small (training's score update and traversal, renewal, the
// binned traversal: k <= 8 over a small (k, L) table). What bounds it:
// device-memory bytes (4 per index read, 4k per row written) at 1M
// rows; at the main path's 100k-row traversal the bytes take ~1 us,
// below a launch's latency, so the launch and the host's enqueue are
// the cost there. The design:
//   - each thread serves 4 consecutive rows per step: one 16-byte load
//     of idx, and one 16-byte store per output row j (row j of out is
//     contiguous in N); a scalar path covers the ragged last group, an
//     idx view that is not 16-byte aligned (vec_idx = 0, decided by the
//     wrapper) and output rows j * N that are not (N not divisible by 4);
//   - the (k, L) table is staged in shared memory transposed to (L, k),
//     so a row's k values are adjacent (two 16-byte reads at k = 8);
//   - the grid is sized to the rows (one 1024-row step per block, capped
//     at one wave by the wrapper), so a 100k-row call stages the table in
//     ~100 blocks, not in 8 per SM;
//   - a table too large for shared memory is read from device memory
//     through the read-only cache instead (kStaged = false).
//
// take_rows (the serving forest's gather, serving/forest.py: k = 9 node
// fields per (row, tree) lane from a (T * max_nodes, 16) table, 8.1 MB
// at 500 trees, 2M lanes a 4096-row level). Read from the (k, L) layout,
// a lane's k fields lie L floats apart: k 32-byte sectors of L2 for 4k
// bytes used, so that gather is bound by L2 sectors, not device memory.
// A node-major record of kRecord = 16 floats (the fields, then zero
// padding; 64 bytes, so a record never straddles a 128-byte line) puts
// the 36 bytes used in two sectors. What bounds it then: device-memory
// bytes (4 per index read, 4k per lane written, 4k per distinct node
// read; the table stays resident in the 50 MB L2 across a replay's
// levels). The design:
//   - each thread serves 4 consecutive lanes per step: one 16-byte load
//     of idx, then ceil(k / 4) independent 16-byte loads of each lane's
//     record (12 in flight at k = 9 before the first store; the padding
//     is never read), then one 16-byte store per output row j, because
//     (k, N) stays the layout the forest's consumers read in planes;
//   - the stores stream (evict-first), so the output, which is larger
//     than L2 at the serving shape, does not push the table out;
//   - the grid and the scalar paths (ragged N, unaligned idx) are
//     take_small's; no shared-memory stage.
#include <cstdint>
#include <cuda_runtime.h>

namespace lgbm_torch {

constexpr int kTakeThreads = 256;
constexpr int kTakeSmemBytes = 48 * 1024;
constexpr int kRecord = 16;  // take_rows: floats a node-major record

// K > 0: k known at compile time (the main path's 1, 2 and 8, and 4);
// K = 0: any k, read one value at a time.
template <int K>
__device__ __forceinline__ void row_vals(const float* __restrict__ sh, int i,
                                         int k, float* v) {
  const float* p = sh + i * (K > 0 ? K : k);
  if (K % 4 == 0 && K > 0) {
#pragma unroll
    for (int j = 0; j < K; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
    }
  } else if (K == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else if (K == 1) {
    v[0] = p[0];
  }
}

template <int K, bool kStaged>
__global__ void take_small_kernel(const float* __restrict__ tab,
                                  const int32_t* __restrict__ idx,
                                  float* __restrict__ out, int k, int L,
                                  int N, int vec_idx) {
  extern __shared__ __align__(16) float sh_tab[];
  if (K > 0) k = K;
  if (kStaged) {  // transposed: value (j, i) at sh_tab[i * k + j]
    for (int e = threadIdx.x; e < k * L; e += blockDim.x) {
      const int j = e / L;
      sh_tab[(e - j * L) * k + j] = tab[e];
    }
    __syncthreads();
  }
  const int64_t groups = ((int64_t)N + 3) / 4;
  for (int64_t q = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       q < groups; q += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r0 = q * 4;
    const int nr = (int)min((int64_t)4, N - r0);
    int ii[4];
    if (nr == 4 && vec_idx) {
      const int4 v = *reinterpret_cast<const int4*>(idx + r0);
      ii[0] = v.x; ii[1] = v.y; ii[2] = v.z; ii[3] = v.w;
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) ii[t] = t < nr ? idx[r0 + t] : -1;
    }
    if (K > 0 && kStaged) {
      // all k values of the 4 rows in registers, then one store per j
      float v[4][K > 0 ? K : 1];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (ii[t] >= 0 && ii[t] < L) {
          row_vals<K>(sh_tab, ii[t], k, v[t]);
        } else {
#pragma unroll
          for (int j = 0; j < K; ++j) v[t][j] = 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float* o = out + (int64_t)j * N + r0;
        if (nr == 4 && (((int64_t)j * N) & 3) == 0) {
          *reinterpret_cast<float4*>(o) =
              make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (t < nr) o[t] = v[t][j];
        }
      }
    } else {
      for (int j = 0; j < k; ++j) {
        float v[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int i = ii[t];
          v[t] = 0.0f;
          if (i >= 0 && i < L)
            v[t] = kStaged ? sh_tab[i * k + j]
                           : __ldg(tab + (int64_t)j * L + i);
        }
        float* o = out + (int64_t)j * N + r0;
        if (nr == 4 && (((int64_t)j * N) & 3) == 0) {
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (t < nr) o[t] = v[t];
        }
      }
    }
  }
}

template <int K>
int launch_take(const void* tab, const void* idx, void* out, int k, int L,
                int N, int num_blocks, int vec_idx, cudaStream_t stream) {
  const int bytes = k * L * (int)sizeof(float);
  if (bytes <= kTakeSmemBytes) {
    take_small_kernel<K, true><<<num_blocks, kTakeThreads, bytes, stream>>>(
        (const float*)tab, (const int32_t*)idx, (float*)out, k, L, N,
        vec_idx);
  } else {
    take_small_kernel<0, false><<<num_blocks, kTakeThreads, 0, stream>>>(
        (const float*)tab, (const int32_t*)idx, (float*)out, k, L, N,
        vec_idx);
  }
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kTakeThreads)
    take_rows_kernel(const float* __restrict__ tab,
                     const int32_t* __restrict__ idx,
                     float* __restrict__ out, int k, int L, int N,
                     int vec_idx) {
  constexpr int Q = kRecord / 4;  // 16-byte words of a record
  const bool vec_out = (N & 3) == 0;
  const int64_t groups = ((int64_t)N + 3) / 4;
  for (int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       g < groups; g += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r0 = g * 4;
    const int nr = (int)min((int64_t)4, N - r0);
    int ii[4];
    if (nr == 4 && vec_idx) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(idx + r0));
      ii[0] = v.x; ii[1] = v.y; ii[2] = v.z; ii[3] = v.w;
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) ii[t] = t < nr ? __ldg(idx + r0 + t) : -1;
    }
    // every load of the 4 records before any store
    float4 rec[4][Q];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const bool ok = ii[t] >= 0 && ii[t] < L;
      const float4* p = reinterpret_cast<const float4*>(
          tab + (int64_t)(ok ? ii[t] : 0) * kRecord);
#pragma unroll
      for (int q = 0; q < Q; ++q)
        rec[t][q] = (ok && 4 * q < k) ? __ldg(p + q)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kRecord; ++j) {
      if (j < k) {
        float v[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float4 w = rec[t][j / 4];
          v[t] = (j % 4 == 0) ? w.x : (j % 4 == 1) ? w.y
                                  : (j % 4 == 2) ? w.z : w.w;
        }
        float* o = out + (int64_t)j * N + r0;
        if (nr == 4 && vec_out) {
          __stcs(reinterpret_cast<float4*>(o),
                 make_float4(v[0], v[1], v[2], v[3]));
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (t < nr) __stcs(o + t, v[t]);
        }
      }
    }
  }
}

}  // namespace lgbm_torch

// tab (k, L) f32, idx (N,) int32, out (k, N) f32, all contiguous, out
// 16-byte aligned; vec_idx: 1 when idx is 16-byte aligned.
extern "C" int lgbm_take_small(const void* tab, const void* idx, void* out,
                               int k, int L, int N, int num_blocks,
                               int vec_idx, void* stream) {
  using namespace lgbm_torch;
  cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
    case 1: return launch_take<1>(tab, idx, out, k, L, N, num_blocks,
                                  vec_idx, st);
    case 2: return launch_take<2>(tab, idx, out, k, L, N, num_blocks,
                                  vec_idx, st);
    case 4: return launch_take<4>(tab, idx, out, k, L, N, num_blocks,
                                  vec_idx, st);
    case 8: return launch_take<8>(tab, idx, out, k, L, N, num_blocks,
                                  vec_idx, st);
    default: return launch_take<0>(tab, idx, out, k, L, N, num_blocks,
                                   vec_idx, st);
  }
}

// tab_rows (L, kRecord) f32 row-major, 0 < k <= kRecord; idx (N,)
// int32; out (k, N) f32; all contiguous, tab_rows and out 16-byte
// aligned; vec_idx: 1 when idx is 16-byte aligned.
extern "C" int lgbm_take_rows(const void* tab, const void* idx, void* out,
                              int k, int L, int N, int num_blocks,
                              int vec_idx, void* stream) {
  using namespace lgbm_torch;
  if (k <= 0 || k > kRecord) return (int)cudaErrorInvalidValue;
  take_rows_kernel<<<num_blocks, kTakeThreads, 0, (cudaStream_t)stream>>>(
      (const float*)tab, (const int32_t*)idx, (float*)out, k, L, N, vec_idx);
  return (int)cudaGetLastError();
}
