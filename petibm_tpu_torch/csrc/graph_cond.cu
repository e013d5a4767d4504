// Conditional IF nodes in a CUDA graph that a stream is capturing: the
// guard of the chunked step's loop bodies (petibm_tpu_torch/utils/graphs.py
// IfNodes, linalg/loops.py GuardedDriver); and the device stamps of a
// traced step (utils/stamps.py), which a capture records as graph nodes.
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

// ---------------------------------------------------------------------
// Device stamps (utils/stamps.py).  Each is a one-thread kernel that reads
// the card's nanosecond clock %globaltimer and writes it, less `base` (a
// reading taken when tracing was switched on), as a float64 into row *j of
// a (rows, width) float64 buffer: the chunk's stats rows, so a chunk still
// makes one host read.  *j is read when the kernel runs, so a graph replay
// writes the row of its own step.  No launch synchronises.

namespace {

__device__ __forceinline__ double clock_since(unsigned long long base) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  return static_cast<double>(static_cast<long long>(now - base));
}

// mode 0: rows[*j][col] = t; mode 1 (a step's first stamp): the same, and
// the regions' `naux` columns from `aux` on set to 0
__global__ void step_stamp(double* rows, const long long* j, int width,
                           int col, int aux, int naux,
                           unsigned long long base, int mode) {
  double* row = rows + (*j) * static_cast<long long>(width);
  row[col] = clock_since(base);
  if (mode == 1)
    for (int i = 0; i < naux; ++i) row[aux + i] = 0.0;
}

// A region's three columns from `col`: its open stamp, its summed ns, its
// count.  mode 0 (open): rows[*j][col] = t; mode 1 (close):
// rows[*j][col + 1] += keep * (t - rows[*j][col]), rows[*j][col + 2] +=
// keep, keep 1 or the masked copy's predicate *kept (null: 1)
__global__ void region_stamp(double* rows, const long long* j, int width,
                             int col, unsigned long long base, int mode,
                             const bool* kept) {
  double* row = rows + (*j) * static_cast<long long>(width);
  double t = clock_since(base);
  if (mode == 0) {
    row[col] = t;
    return;
  }
  double keep = (kept == nullptr || *kept) ? 1.0 : 0.0;
  row[col + 1] += keep * (t - row[col]);
  row[col + 2] += keep;
}

__global__ void read_clock(long long* out) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  *out = static_cast<long long>(now);
}

// the smallest and the largest step of %globaltimer over `n` changes
__global__ void clock_steps(long long* out, int n) {
  unsigned long long prev, now;
  long long lo = -1, hi = 0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(prev));
  for (int i = 0; i < n; ++i) {
    do {
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    } while (now == prev);
    long long d = static_cast<long long>(now - prev);
    if (lo < 0 || d < lo) lo = d;
    if (d > hi) hi = d;
    prev = now;
  }
  out[0] = lo;
  out[1] = hi;
}

}  // namespace

extern "C" int graph_step_stamp(void* stream, double* rows,
                                const long long* j, int width, int col,
                                int aux, int naux, unsigned long long base,
                                int mode) {
  step_stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, j, width, col, aux, naux, base, mode);
  return cudaGetLastError();
}

extern "C" int graph_region_stamp(void* stream, double* rows,
                                  const long long* j, int width, int col,
                                  unsigned long long base, int mode,
                                  const bool* kept) {
  region_stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, j, width, col, base, mode, kept);
  return cudaGetLastError();
}

extern "C" int graph_read_clock(void* stream, long long* out) {
  read_clock<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(out);
  return cudaGetLastError();
}

extern "C" int graph_clock_steps(void* stream, long long* out, int n) {
  clock_steps<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(out, n);
  return cudaGetLastError();
}
