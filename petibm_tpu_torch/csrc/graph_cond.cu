// Conditional IF nodes in a CUDA graph that a stream is capturing: the
// guard of the chunked step's loop bodies (petibm_tpu_torch/utils/graphs.py
// IfNodes, linalg/loops.py GuardedDriver).
//
// PyTorch 2.11 exposes no conditional node (its CUDAGraph has no
// begin_capture_to_if_node), so the port adds one the way the CUDA
// programming guide's "Conditional graph nodes" section does under stream
// capture:
//
//   graph_if_begin(stream, pred, child, mode)
//     1. finds the graph `stream` is capturing into and the nodes its next
//        node depends on (cudaStreamGetCaptureInfo);
//     2. creates a conditional handle in that graph, default value 0;
//     3. captures, on `stream`, a one-thread kernel that sets the handle
//        from the device bool *pred when the graph runs;
//     4. adds an IF node on the handle after that kernel, and makes it the
//        node the stream's next work depends on;
//     5. begins capturing `child` into the IF node's body graph.
//   graph_if_end(child) ends that capture.
//
// The work between the two calls goes to `child` (the caller makes it the
// current stream), so it lands in the body, which a replay runs only where
// *pred is true when the IF node is reached: a skipped body launches
// nothing.  Requires CUDA 12.4 or later (IF nodes of one body captured
// from a stream).

#include <cuda_runtime.h>

namespace {

__global__ void set_conditional(cudaGraphConditionalHandle handle,
                                const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" int graph_if_begin(void* stream, const bool* pred, void* child,
                              int mode) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph,
                                             &deps, &ndeps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_conditional<<<1, 1, 0, s>>>(handle, pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(
      s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(child), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, static_cast<cudaStreamCaptureMode>(mode));
}

extern "C" int graph_if_end(void* child) {
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(child), &body);
}
