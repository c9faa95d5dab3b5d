// A device-side while loop inside a CUDA-graph capture: the conditional
// WHILE node of CUDA 12.4 (CUDA C++ Programming Guide, "Conditional
// Graph Nodes"), for paddle.static.nn.while_loop under a captured step.
//
// Replaces: the `lax.while_loop` that paddle_tpu/ops/control_flow.py:61-75
// lowers while_loop to, which runs inside the compiled step with its trip
// count decided on the device. The host never reads the predicate: the
// graph's WHILE node runs its body graph again for as long as the body's
// last kernel sets the node's condition to a non-zero value.
//
// How ops/control_flow.py drives it while a stream is being captured:
//  1. pt_graph_while_begin(stream, pred): takes the graph being captured
//     and the stream's current dependencies (cudaStreamGetCaptureInfo),
//     makes a condition handle (cudaGraphConditionalHandleCreate),
//     launches set_condition on the stream (it is captured: it sets the
//     first predicate from the device flag `pred`), adds the WHILE node
//     after it (cudaGraphAddNode) and makes the node the stream's only
//     dependency (cudaStreamUpdateCaptureDependencies). It returns the
//     node's body graph and the handle.
//  2. pt_graph_capture_to(side, body): the body is captured on a second
//     stream straight into the body graph (cudaStreamBeginCaptureToGraph).
//     The caller runs the loop's body there, copies its results into the
//     loop-carried buffers, evaluates the condition again and calls
//     pt_graph_while_set(side, handle, pred), which launches set_condition
//     as the body's last kernel.
//  3. pt_graph_capture_end(side) ends the body's capture.
// The loop-carried buffers live in the outer graph's memory; the body's
// own temporaries come from a private pool of the caching allocator
// (ops/control_flow.py).
//
// set_condition is the one kernel of this file: one thread, one read of a
// 32-bit flag, one cudaGraphSetConditional.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const int* pred) {
  cudaGraphSetConditional(handle, *pred != 0 ? 1u : 0u);
}

}  // namespace

// CUDA runtime and driver versions (e.g. 12040 for 12.4); 0 on success.
// It also loads set_condition's module (cudaFuncGetAttributes), with the
// thread's capture mode relaxed: the first while_loop is usually met
// inside a capture, where lazy loading must not be the first thing a
// captured call does.
extern "C" int pt_graph_versions(int* runtime, int* driver) {
  cudaError_t e = cudaRuntimeGetVersion(runtime);
  if (e != cudaSuccess) return (int)e;
  e = cudaDriverGetVersion(driver);
  if (e != cudaSuccess) return (int)e;
  cudaStreamCaptureMode mode = cudaStreamCaptureModeRelaxed;
  e = cudaThreadExchangeStreamCaptureMode(&mode);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  const cudaError_t got = cudaFuncGetAttributes(&attr, set_condition);
  e = cudaThreadExchangeStreamCaptureMode(&mode);
  return (int)(got != cudaSuccess ? got : e);
}

// Steps 1 of the header on `stream`, which must be capturing. pred: a
// device int32 (non-zero: run the body). Writes the body graph and the
// handle; returns 0, a cudaError_t code, or -1 if the stream is not
// capturing.
extern "C" int pt_graph_while_begin(void* stream_ptr, const int* pred,
                                    void** body_out,
                                    unsigned long long* handle_out) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph,
                                           &deps, &ndeps);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive) return -1;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return (int)e;
  set_condition<<<1, 1, 0, stream>>>(handle, pred);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps,
                               &ndeps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  *body_out = params.conditional.phGraph_out[0];
  *handle_out = (unsigned long long)handle;
  return 0;
}

// The body's last kernel: the condition of the next trip from `pred`.
extern "C" int pt_graph_while_set(void* stream_ptr, unsigned long long handle,
                                  const int* pred) {
  set_condition<<<1, 1, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      (cudaGraphConditionalHandle)handle, pred);
  return (int)cudaGetLastError();
}

// Capture `stream` into the (empty) graph `graph`, in relaxed mode.
extern "C" int pt_graph_capture_to(void* stream_ptr, void* graph) {
  return (int)cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(stream_ptr), static_cast<cudaGraph_t>(graph),
      nullptr, nullptr, 0, cudaStreamCaptureModeRelaxed);
}

// End the capture begun by pt_graph_capture_to; the graph must be
// `graph` (the body graph the capture wrote into).
extern "C" int pt_graph_capture_end(void* stream_ptr, void* graph) {
  cudaGraph_t out = nullptr;
  cudaError_t e =
      cudaStreamEndCapture(static_cast<cudaStream_t>(stream_ptr), &out);
  if (e != cudaSuccess) return (int)e;
  return out == static_cast<cudaGraph_t>(graph) ? 0 : -2;
}
