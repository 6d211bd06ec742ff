// Conditional nodes in a stream capture, CUDA C++ for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package compiles its tracking step's
// data-dependent branches into lax.cond inside one jitted lax.scan
// (tinyslam_tpu/models/vo_device.py:310, 390, 393, 412, 447, 478); on the
// card the port captures the step into a CUDA graph, and each branch body
// becomes the body of an IF node that runs only where its predicate holds
// (tinyslam_tpu_torch/utils/cuda_graph.py).  PyTorch 2.11, the card's,
// has no binding for conditional nodes, so these entry points add one to
// a capture in progress:
//
//   tinyslam_graph_if_begin(stream, pred, negate, body_stream)
//     on `stream`, which is capturing: create a conditional handle (reset
//     to 0 at every launch of the graph), capture one launch of
//     set_condition (one thread: the handle <- *pred, or its negation),
//     add an IF node after it whose body is a new empty graph, make that
//     node the stream's only capture dependency, and begin capturing
//     `body_stream` into the body graph;
//   tinyslam_graph_if_end(body_stream)
//     end that capture.
//
// The caller launches the body's work on `body_stream` in between; bodies
// nest (CUDA 12.4 and later), each on a stream of its own depth.  The one
// kernel reads one byte and sets one word: it is bound by its launch, and
// its cost is that of a node in the graph, on the card, in place of a
// host read of the predicate (a synchronization) in the eager version.
// Every entry point returns the first CUDA error it met, or 0.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle, const bool* pred,
                              int negate) {
  const bool taken = (*pred) != (negate != 0);
  cudaGraphSetConditional(handle, taken ? 1u : 0u);
}

}  // namespace

extern "C" int tinyslam_graph_if_begin(cudaStream_t stream, const void* pred, int negate,
                                       cudaStream_t body_stream) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureInvalidated;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault);
  if (e != cudaSuccess) return (int)e;
  set_condition<<<1, 1, 0, stream>>>(handle, static_cast<const bool*>(pred), negate);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamBeginCaptureToGraph(body_stream, params.conditional.phGraph_out[0],
                                            nullptr, nullptr, 0,
                                            cudaStreamCaptureModeThreadLocal);
}

extern "C" int tinyslam_graph_if_end(cudaStream_t body_stream) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture(body_stream, &body);
}
