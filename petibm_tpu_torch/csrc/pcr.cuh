// Shared pieces of the line kernels K4/K5 (line_sweep.cu) and K6/K7
// (tridiag_pcr.cu): the tiling of a batch of grid lines into thread
// blocks, and parallel cyclic reduction (PCR) on lines held in shared
// memory.
//
// A field is a C-contiguous (n0, n1, n2) array (a 2D field is (1, n1, n2)).
// A "line" runs along one axis; the other two axes index the batch of
// lines in row-major order.  A block holds `lt` whole lines, every row of
// them, in shared memory: four arrays (a, b, c, d) of n * lt values.  When
// the line axis is the contiguous one the rows of a line are the fast
// index of the block's threads (row_fast); otherwise the lines are, so
// that neighbouring threads read neighbouring addresses either way.
//
// PCR: pass k (k = 1, 2, 4, ...) eliminates the +-k couplings of every row,
// reading out-of-range neighbour diagonals as 1 and off-diagonals and right
// sides as 0, in the order of operations of the plain twin
// (petibm_tpu_torch/linalg/tridiag.py): after ceil(log2 n) passes x = d / b.

#pragma once

#include <cuda_runtime.h>

namespace pcr {

// Rows of one line a block takes in shared memory at most (x 4 arrays x
// 8 bytes = 128 KB in float64), and the values a block is sized to.
constexpr int kMaxLine = 4096;
constexpr int kBlockValues = 2048;
// threads per block at most; the kernels declare it as their launch
// bound, which holds them to 64 registers a thread
constexpr int kMaxThreads = 1024;
// values per thread: ceil(max(kBlockValues, kMaxLine) / kMaxThreads)
constexpr int kPerThread = 4;

struct Lines {
  long long shape[3];    // (n0, n1, n2)
  long long stride[3];   // C-contiguous strides
  int axis;              // line axis
  int o0, o1;            // batch axes, outer and inner
  int n;                 // line length
  long long nlines;      // lines in the batch
  int lt;                // lines per block
  int row_fast;          // rows are the fast thread index
  int threads;           // threads per block
  int steps;             // PCR passes
  // shape[o1], stride[o0], stride[o1], stride[axis]: read per value, kept
  // apart so that no runtime index into the arrays is needed
  long long inner, s_o0, s_o1, s_line;
};

// Tiling of the lines along `axis`; returns false when a line is longer
// than kMaxLine or the shape is empty.
inline bool make_lines(long long n0, long long n1, long long n2, int axis,
                       Lines* g) {
  if (axis < 0 || axis > 2 || n0 <= 0 || n1 <= 0 || n2 <= 0) return false;
  g->shape[0] = n0;
  g->shape[1] = n1;
  g->shape[2] = n2;
  g->stride[2] = 1;
  g->stride[1] = n2;
  g->stride[0] = n1 * n2;
  g->axis = axis;
  g->o0 = axis == 0 ? 1 : 0;
  g->o1 = axis == 2 ? 1 : 2;
  if (g->shape[axis] > kMaxLine) return false;
  g->n = (int)g->shape[axis];
  g->nlines = g->shape[g->o0] * g->shape[g->o1];
  long long lt = kBlockValues / g->n;
  if (lt < 1) lt = 1;
  if (lt > 64) lt = 64;
  if (lt > g->nlines) lt = g->nlines;
  g->lt = (int)lt;
  g->row_fast = axis == 2;
  const int m = g->n * g->lt;
  int threads = ((m + 31) / 32) * 32;
  g->threads = threads < kMaxThreads ? threads : kMaxThreads;
  g->steps = 0;
  while ((1LL << g->steps) < g->n) ++g->steps;
  g->inner = g->shape[g->o1];
  g->s_o0 = g->stride[g->o0];
  g->s_o1 = g->stride[g->o1];
  g->s_line = g->stride[axis];
  return true;
}

inline long long blocks(const Lines& g) {
  return (g.nlines + g.lt - 1) / g.lt;
}

// One value of a block: its row, shared-memory slot and global offset
// (kept small: a thread holds kPerThread of them through the passes).
struct Slot {
  long long offset;
  int sid;
  int row;
  bool active;       // the value exists in this block's tile
  bool valid;        // ... and its line exists in the batch
};

// The slot of value `idx` of the block; `line` receives its line's index
// in the batch.
__device__ inline Slot slot(const Lines& g, int idx, long long* line) {
  Slot s;
  const int m = g.n * g.lt;
  s.active = idx < m;
  int lane, row;
  if (g.row_fast) {
    row = idx % g.n;
    lane = idx / g.n;
  } else {
    lane = idx % g.lt;
    row = idx / g.lt;
  }
  s.row = row;
  s.sid = g.row_fast ? lane * g.n + row : row * g.lt + lane;
  *line = (long long)blockIdx.x * g.lt + lane;
  s.valid = s.active && *line < g.nlines;
  s.offset = (*line / g.inner) * g.s_o0 + (*line % g.inner) * g.s_o1 +
             (long long)row * g.s_line;
  return s;
}

// Shared-memory distance between rows i and i + 1 of one line.
__device__ inline int row_step(const Lines& g) {
  return g.row_fast ? 1 : g.lt;
}

// `steps` PCR passes over the block's lines in shared memory (a, b, c, d
// of n * lt values); every thread of the block calls it.  Slots that are
// not active hold nothing; slots of lines past the batch hold the benign
// system a = c = d = 0, b = 1.
template <typename T>
__device__ void passes(const Lines& g, const Slot* slots, int steps, T* sa,
                       T* sb, T* sc, T* sd) {
  const int rstep = row_step(g);
  int k = 1;
  for (int s = 0; s < steps; ++s) {
    T na[kPerThread], nb[kPerThread], nc[kPerThread], nd[kPerThread];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      if (!slots[r].active) continue;
      const int i = slots[r].sid;
      const bool lo = slots[r].row - k >= 0;
      const bool hi = slots[r].row + k < g.n;
      const int il = i - k * rstep;
      const int ih = i + k * rstep;
      const T alpha = -sa[i] / (lo ? sb[il] : T(1));
      const T beta = -sc[i] / (hi ? sb[ih] : T(1));
      na[r] = alpha * (lo ? sa[il] : T(0));
      nb[r] = sb[i] + alpha * (lo ? sc[il] : T(0)) + beta * (hi ? sa[ih] : T(0));
      nc[r] = beta * (hi ? sc[ih] : T(0));
      nd[r] = sd[i] + alpha * (lo ? sd[il] : T(0)) + beta * (hi ? sd[ih] : T(0));
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      if (!slots[r].active) continue;
      const int i = slots[r].sid;
      sa[i] = na[r];
      sb[i] = nb[r];
      sc[i] = nc[r];
      sd[i] = nd[r];
    }
    __syncthreads();
    k *= 2;
  }
}

// Dynamic shared memory of a block: four arrays of n * lt values.
template <typename T>
inline size_t shared_bytes(const Lines& g) {
  return 4 * sizeof(T) * (size_t)g.n * (size_t)g.lt;
}

// Allow every kernel instance the shared memory of the longest line (above
// the 48 KB default); once per instance.
template <typename K>
inline cudaError_t allow_shared(K kernel, size_t bytes_of_value) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(4 * bytes_of_value * kMaxLine));
}

}  // namespace pcr
