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
// The pose-graph solve's 20 Gauss-Newton steps are a lax.scan in the JAX
// package (tinyslam_tpu/backend/pose_graph.py:144); the port captures one
// step as the body of a WHILE node, which runs it while a device flag holds:
//
//   tinyslam_graph_while_begin(stream, pred, body_stream, handle_out)
//     as tinyslam_graph_if_begin, with a WHILE node, the handle written to
//     *handle_out;
//   tinyslam_graph_while_end(body_stream, handle, pred)
//     capture one launch of set_condition (the handle <- *pred, which the
//     body has computed for the next turn) at the body's end, and end the
//     body's capture.
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

// Begin a conditional node of `type` on the capturing `stream`, its
// condition set from *pred (negated where `negate`) just before it, and the
// capture of its body on `body_stream`.
int begin_conditional(cudaStream_t stream, const void* pred, int negate,
                      cudaGraphConditionalNodeType type, cudaStream_t body_stream,
                      cudaGraphConditionalHandle* handle_out) {
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
  params.conditional.type = type;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  if (handle_out != nullptr) *handle_out = handle;
  return (int)cudaStreamBeginCaptureToGraph(body_stream, params.conditional.phGraph_out[0],
                                            nullptr, nullptr, 0,
                                            cudaStreamCaptureModeThreadLocal);
}

}  // namespace

extern "C" int tinyslam_graph_if_begin(cudaStream_t stream, const void* pred, int negate,
                                       cudaStream_t body_stream) {
  return begin_conditional(stream, pred, negate, cudaGraphCondTypeIf, body_stream, nullptr);
}

extern "C" int tinyslam_graph_if_end(cudaStream_t body_stream) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture(body_stream, &body);
}

extern "C" int tinyslam_graph_while_begin(cudaStream_t stream, const void* pred,
                                          cudaStream_t body_stream,
                                          unsigned long long* handle_out) {
  cudaGraphConditionalHandle handle = 0;
  const int e = begin_conditional(stream, pred, 0, cudaGraphCondTypeWhile, body_stream,
                                  &handle);
  *handle_out = (unsigned long long)handle;
  return e;
}

extern "C" int tinyslam_graph_while_end(cudaStream_t body_stream, unsigned long long handle,
                                        const void* pred) {
  set_condition<<<1, 1, 0, body_stream>>>((cudaGraphConditionalHandle)handle,
                                           static_cast<const bool*>(pred), 0);
  const cudaError_t launched = cudaGetLastError();
  cudaGraph_t body;
  const cudaError_t ended = cudaStreamEndCapture(body_stream, &body);
  return (int)(launched != cudaSuccess ? launched : ended);
}
