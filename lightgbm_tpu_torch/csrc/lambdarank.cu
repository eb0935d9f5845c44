// lambdarank: LambdaRank's per-document gradients and hessians, one block
// a query.
//
// Replaces the XLA code of lightgbm_tpu/learner/ranking.py
// lambdarank_gradients (:109), which is no pallas_call: the JAX package
// builds a padded (Q, M, M) pair tensor (M the largest query's documents)
// in lax.map steps of a few queries. At MSLR-WEB10K's shape (10,000
// queries, a tail to ~900 documents) that is ~8e9 pair cells, of which the
// reference's loop (rank_objective.hpp:182-271: i below the truncation
// level, j after i) touches ~4e7; a step of ~40 torch ops a query cannot
// go into a CUDA graph either. Here a block owns one query through its
// offsets, so nothing is padded:
//   1. the query's scores and labels go to shared memory;
//   2. each document's rank in the sorted order comes from counting:
//      p(d) = #{e : s_e > s_d, or s_e == s_d and e < d}, which is
//      argsort(-s, stable) exactly (equal scores, as in iteration 0,
//      order documents by their index); the sorted scores and labels go
//      to shared memory at p(d);
//   3. each document sums its pairs in a fixed order, as the higher
//      member over j = p+1 .. cnt-1 when p < trunc and as the lower
//      member over i = 0 .. min(p, trunc)-1; only pairs of unequal labels
//      count. The two sums (the row of the pair matrix and its column)
//      stay apart until the end, as the JAX package keeps them;
//   4. with norm, the query's sum of lambdas (each pair counted once, by
//      its higher member) is a fixed-order tree reduction in shared
//      memory, and best != worst reads the sorted scores' ends;
//   5. the scale, the document weights and the 2e-7 hessian floor are
//      applied in the same launch, and each row is written once.
// The expressions keep the JAX package's order of operations (a product
// that a sum takes is rounded first, __fmul_rn, as torch rounds it, not
// fused into an FMA); only the order of the sums differs from the plain
// version's, so the two agree to f32 rounding.
// No float atomics: every output is the same bits on every run. Blocks
// past the last query write the padding rows (g 0, h the floor or 0).
// The pair work is unbalanced (the first `trunc` ranks carry most of it);
// a query's block costs ~cnt pair steps on its slowest thread.
#include <cstdint>
#include <cuda_runtime.h>

namespace lgbm_torch {

constexpr int kRankThreads = 256;

__device__ __forceinline__ float gain_of(const float* __restrict__ label_gain,
                                         int num_gain, float l) {
  int li = (int)l;
  li = li < 0 ? 0 : (li >= num_gain ? num_gain - 1 : li);
  return label_gain[li];
}

__global__ void __launch_bounds__(kRankThreads)
lambdarank_kernel(const float* __restrict__ score,
                  const float* __restrict__ label,
                  const int32_t* __restrict__ qoff, int Q,
                  const float* __restrict__ label_gain, int num_gain,
                  const float* __restrict__ inv_max_dcg,
                  const float* __restrict__ disc,
                  const float* __restrict__ weight, float* __restrict__ grad,
                  float* __restrict__ hess, int npad, int cap, float sig,
                  float neg_sig, float sig2, int trunc, int norm,
                  int floor_on, float floor_val) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  if ((int)blockIdx.x >= Q) {  // the padding rows after the last query
    const int64_t r = qoff[Q] + (int64_t)(blockIdx.x - Q) * blockDim.x + tid;
    if (r < npad) {
      grad[r] = 0.0f;
      hess[r] = floor_on ? fmaxf(0.0f, floor_val) : 0.0f;
    }
    return;
  }
  const int q = blockIdx.x;
  const int b = qoff[q];
  const int cnt = qoff[q + 1] - b;
  float* s_doc = sm;              // scores in document order, then g
  float* l_doc = s_doc + cap;     // labels in document order, then h
  float* ss = l_doc + cap;        // scores in sorted order
  float* sl = ss + cap;           // labels in sorted order
  int* pos = reinterpret_cast<int*>(sl + cap);  // rank of each document
  float* red = reinterpret_cast<float*>(pos + cap);  // kRankThreads
  for (int d = tid; d < cnt; d += blockDim.x) {
    s_doc[d] = score[b + d];
    l_doc[d] = label[b + d];
  }
  __syncthreads();
  for (int d = tid; d < cnt; d += blockDim.x) {
    const float s = s_doc[d];
    int p = 0;
    for (int e = 0; e < cnt; ++e) {
      const float t = s_doc[e];
      p += (t > s) || (t == s && e < d);
    }
    pos[d] = p;
    ss[p] = s;
    sl[p] = l_doc[d];
  }
  __syncthreads();
  const float im = inv_max_dcg[q];
  const bool reg = norm && cnt > 0 && ss[0] != ss[cnt - 1];
  float lam_sum = 0.0f;
  for (int d = tid; d < cnt; d += blockDim.x) {
    const int p = pos[d];
    const float s_p = ss[p], l_p = sl[p];
    const float g_p = gain_of(label_gain, num_gain, l_p);
    const float d_p = disc[p];
    float row_g = 0.0f, row_h = 0.0f, col_g = 0.0f, col_h = 0.0f;
    if (p < trunc) {
      for (int j = p + 1; j < cnt; ++j) {  // pairs (p, j): p the higher rank
        const float l_j = sl[j];
        if (l_j == l_p) continue;
        const bool high = l_p > l_j;
        const float ds = high ? s_p - ss[j] : ss[j] - s_p;
        float dndcg = fabsf(g_p - gain_of(label_gain, num_gain, l_j)) *
                      fabsf(d_p - disc[j]) * im;
        if (reg) dndcg = dndcg / (0.01f + fabsf(ds));
        const float pr = 1.0f / (1.0f + expf(sig * ds));
        const float lam = __fmul_rn(neg_sig * dndcg, pr);
        row_g += high ? lam : -lam;
        row_h += __fmul_rn(sig2 * dndcg * pr, 1.0f - pr);
        lam_sum += lam;
      }
    }
    const int ilim = p < trunc ? p : trunc;
    for (int i = 0; i < ilim; ++i) {  // pairs (i, p): i the higher rank
      const float l_i = sl[i];
      if (l_i == l_p) continue;
      const bool high = l_i > l_p;
      const float ds = high ? ss[i] - s_p : s_p - ss[i];
      float dndcg = fabsf(gain_of(label_gain, num_gain, l_i) - g_p) *
                    fabsf(disc[i] - d_p) * im;
      if (reg) dndcg = dndcg / (0.01f + fabsf(ds));
      const float pr = 1.0f / (1.0f + expf(sig * ds));
      const float lam = __fmul_rn(neg_sig * dndcg, pr);
      col_g += high ? lam : -lam;
      col_h += __fmul_rn(sig2 * dndcg * pr, 1.0f - pr);
    }
    s_doc[d] = row_g - col_g;  // this thread's own document: no race
    l_doc[d] = row_h + col_h;
  }
  float scale = 1.0f;
  if (norm) {
    red[tid] = lam_sum;
    __syncthreads();
    for (int w = kRankThreads / 2; w > 0; w >>= 1) {
      if (tid < w) red[tid] = red[tid] + red[tid + w];
      __syncthreads();
    }
    const float sum_lambdas = -2.0f * red[0];
    if (sum_lambdas > 0.0f) scale = log2f(1.0f + sum_lambdas) / sum_lambdas;
  }
  for (int d = tid; d < cnt; d += blockDim.x) {
    float g = s_doc[d], h = l_doc[d];
    if (norm) {
      g = g * scale;
      h = h * scale;
    }
    if (weight != nullptr) {
      const float w = weight[b + d];
      g = g * w;
      h = h * w;
    }
    if (floor_on) h = fmaxf(h, floor_val);
    grad[b + d] = g;
    hess[b + d] = h;
  }
}

}  // namespace lgbm_torch

// score, label (npad,) f32; qoff (Q + 1,) int32 query offsets; label_gain
// (num_gain,) f32; inv_max_dcg (Q,) f32; disc (>= cap,) f32 1 / log2(r + 2);
// weight (npad,) f32 or null; grad, hess (npad,) f32 out. cap: the largest
// query's documents (every block's shared memory holds cap documents);
// pad_blocks: blocks of kRankThreads rows after the last query. smem: the
// dynamic shared memory (5 cap + kRankThreads words), checked against the
// card's limit by the wrapper.
extern "C" int lgbm_lambdarank(const void* score, const void* label,
                               const void* qoff, int Q, const void* label_gain,
                               int num_gain, const void* inv_max_dcg,
                               const void* disc, const void* weight,
                               void* grad, void* hess, int npad, int cap,
                               int pad_blocks, float sig, float neg_sig,
                               float sig2, int trunc, int norm, int floor_on,
                               float floor_val, int smem, void* stream) {
  using namespace lgbm_torch;
  static int smem_set = 0;
  if (smem > 48 * 1024 && smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        lambdarank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const int blocks = Q + pad_blocks;
  if (blocks == 0) return 0;
  lambdarank_kernel<<<blocks, kRankThreads, smem, (cudaStream_t)stream>>>(
      (const float*)score, (const float*)label, (const int32_t*)qoff, Q,
      (const float*)label_gain, num_gain, (const float*)inv_max_dcg,
      (const float*)disc, (const float*)weight, (float*)grad, (float*)hess,
      npad, cap, sig, neg_sig, sig2, trunc, norm, floor_on, floor_val);
  return (int)cudaGetLastError();
}
