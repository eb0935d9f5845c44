// CUDA graphs for the fused training loop: stream capture, replay, and
// IF conditional nodes whose body runs only when a device predicate is
// true.
//
// Not a port of a TPU kernel. The JAX package keeps a tree's rounds, the
// traversal's levels and a dispatch's iterations on the device with
// lax.while_loop / lax.scan inside one XLA program; here one iteration is
// captured once as a CUDA graph and replayed, and each loop step that may
// be skipped sits in an IF node on a predicate the graph computes
// itself, so a replay reads nothing back to the host.
//
// The interface is plain C, like the kernels': the caller
// (learner/device_loop.py) owns the streams and routes the allocations made during
// capture to one memory pool. A conditional body is captured on its own
// stream (cudaStreamBeginCaptureToGraph into the node's body graph), as
// PyTorch's own CUDAGraph.begin_capture_to_if_node does; the parent
// stream's capture then depends on the conditional node, so everything
// captured after the body waits for it.
#include <cstring>
#include <cuda_runtime.h>

namespace lgbm_torch {

__global__ void set_if_kernel(cudaGraphConditionalHandle h,
                              const unsigned char* pred) {
  cudaGraphSetConditional(h, *pred ? 1u : 0u);
}

}  // namespace lgbm_torch

// Begin capturing `stream` (relaxed mode: the caching allocator may still
// call cudaMalloc; a read back to the host fails the capture).
extern "C" int lgbm_graph_begin(void* stream) {
  return (int)cudaStreamBeginCapture((cudaStream_t)stream,
                                     cudaStreamCaptureModeRelaxed);
}

// End the capture of `stream`, instantiate it and upload it to the card;
// nodes_out: the top-level node count.
extern "C" int lgbm_graph_end(void* stream, void** graph_out,
                              void** exec_out, long long* nodes_out) {
  cudaGraph_t g = nullptr;
  cudaError_t e = cudaStreamEndCapture((cudaStream_t)stream, &g);
  if (e != cudaSuccess) return (int)e;
  size_t n = 0;
  e = cudaGraphGetNodes(g, nullptr, &n);
  if (e != cudaSuccess) return (int)e;
  cudaGraphExec_t x = nullptr;
  e = cudaGraphInstantiate(&x, g, 0);
  if (e == cudaSuccess) {
    // upload now, so the first replay does not pay for it
    e = cudaGraphUpload(x, (cudaStream_t)stream);
    if (e != cudaSuccess) cudaGraphExecDestroy(x);
  }
  if (e != cudaSuccess) {
    cudaGraphDestroy(g);
    return (int)e;
  }
  *graph_out = (void*)g;
  *exec_out = (void*)x;
  *nodes_out = (long long)n;
  return 0;
}

extern "C" int lgbm_graph_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

extern "C" int lgbm_graph_destroy(void* graph, void* exec) {
  cudaError_t e = cudaSuccess;
  if (exec != nullptr) e = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  if (graph != nullptr) {
    const cudaError_t e2 = cudaGraphDestroy((cudaGraph_t)graph);
    if (e == cudaSuccess) e = e2;
  }
  return (int)e;
}

// Add an IF node to the graph `parent` is capturing, its condition set by
// a kernel from the one-byte device bool `pred`, make the parent's later
// work depend on it, and begin capturing `child` into its body.
extern "C" int lgbm_if_begin(void* parent, void* child, const void* pred) {
  cudaStream_t ps = (cudaStream_t)parent;
  cudaStreamCaptureStatus st;
  cudaGraph_t g = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(ps, &st, nullptr, &g, &deps,
                                           &ndeps);
  if (e != cudaSuccess) return (int)e;
  if (st != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureUnmatched;
  cudaGraphConditionalHandle h;
  e = cudaGraphConditionalHandleCreate(&h, g, 0, cudaGraphCondAssignDefault);
  if (e != cudaSuccess) return (int)e;
  lgbm_torch::set_if_kernel<<<1, 1, 0, ps>>>(
      h, (const unsigned char*)pred);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamGetCaptureInfo(ps, &st, nullptr, &g, &deps, &ndeps);
  if (e != cudaSuccess) return (int)e;
  // cudaGraphNodeParams has no default constructor (a union of node
  // kinds): zeroed storage, then the conditional kind's fields
  alignas(cudaGraphNodeParams) unsigned char raw[sizeof(cudaGraphNodeParams)];
  std::memset(raw, 0, sizeof(raw));
  cudaGraphNodeParams& p = *reinterpret_cast<cudaGraphNodeParams*>(raw);
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = cudaGraphCondTypeIf;
  p.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, g, deps, ndeps, &p);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(ps, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamBeginCaptureToGraph(
      (cudaStream_t)child, p.conditional.phGraph_out[0], nullptr, nullptr, 0,
      cudaStreamCaptureModeRelaxed);
}

// End the capture of an IF node's body; nodes_out: the body's top-level
// node count.
extern "C" int lgbm_if_end(void* child, long long* nodes_out) {
  cudaGraph_t body = nullptr;
  cudaError_t e = cudaStreamEndCapture((cudaStream_t)child, &body);
  if (e != cudaSuccess) return (int)e;
  size_t n = 0;
  e = cudaGraphGetNodes(body, nullptr, &n);
  *nodes_out = (long long)n;
  return (int)e;
}
