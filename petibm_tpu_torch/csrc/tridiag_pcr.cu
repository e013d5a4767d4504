// Batched tridiagonal solve along one axis by parallel cyclic reduction
// (kernels K6/K7 of the port).
//
// Replaces petibm_tpu/linalg/pallas_pcr.py:pcr_pallas (K6, the whole-array
// Pallas kernel, body _make_kernel) and pcr_pallas_blocked (K7, the same
// body gridded over a batch axis).  The K6/K7 split sizes the arrays to TPU
// VMEM; here one entry point serves both.  The multigrid smoother calls it
// on levels with a periodic axis (petibm_tpu_torch/linalg/mg.py _line_sweep):
//
//   a[i] x[i-1] + b[i] x[i] + c[i] x[i+1] = d[i]   along `axis`,
//
// with a[first] and c[last] ignored, as the twin tridiag_solve_pcr ignores
// them.  a, b, c, d and x are dense C-contiguous arrays of one shape.  Every
// row is computed with the twin's formula in the twin's order (built with
// --fmad=false), so the result equals the twin's bit for bit.
//
// Bound, at the TGV's finest level (256^3): device-memory bandwidth.  Four
// arrays are read and one written once, 335 MB in float32: 100 us at
// 3.35 TB/s (200 us in float64).  The arithmetic, ~14 operations a row in
// each of the 8 passes, is ~24 us at 67 TFLOP/s.  What kept the first
// design (the block path below) at 11% of the bound: two block-wide
// barriers a pass over 1024-thread blocks, ~16 shared-memory accesses a row
// a pass, and 64-bit divisions per value.
//
// Measured at 256^3 on an H100 80GB HBM3 at 700 W (float32),
// scripts/bench_torch_pcr.py: the register paths take 279 us
// (axis 2) and 320 us (axes 0, 1), of which the loads and stores alone
// take 70 and 183-203 us: the passes (two IEEE divisions and up to eight
// shuffles a row a pass) are bound by instruction issue.  Specialising
// full lines saves 17-23%; 16 lines a warp_tiles block cost 5-8% more.
//
// Design.  The wrapper (linalg/cuda_pcr.py launch_plan) hands in a plan:
//
// - Register paths (the passes in pcr_warp.cuh, shared with K4/K5), lines
//   of at most kWarpLine = 256 rows: one warp holds
//   one line, row i = 32 r + lane in register r (r < R <= 8) of lane
//   i % 32, so every register's load or store is 32 consecutive rows.  A
//   pass with k < 32 takes rows i -+ k from lane (lane -+ k) % 32 with one
//   shuffle a value, the sending lane choosing register r or r -+ 1; a pass
//   with k >= 32 finds them in register r -+ k/32 of its own lane.  No
//   block-wide barrier and no shared memory inside the passes.
//   * warp_rows (line axis 2, contiguous): each lane loads its rows itself.
//   * warp_tiles (line axes 0 and 1): a block solves W = 8 lines that lie
//     next to each other along the contiguous axis (rows of 32 bytes in
//     float32).  It stages a, b, c and d with cp.async in rows of W values
//     into shared memory padded to W + 1 columns, so that a warp reading
//     its line (a column) touches 32 different banks, and writes x back
//     through the same staging: two block barriers a launch.
//   Lines that fill the warp (n = 32 R, as every TGV level has) know
//   their rows out of range and their passes at compile time.
//   One division a block (or none); offsets inside a block in 32 bits (the
//   plan takes these paths only for arrays of fewer than 2^31 values).
// - Block path, lines of 257 to pcr::kMaxLine = 4096 rows: a block holds
//   whole lines in shared memory and runs the passes there (pcr.cuh).
//
// bfloat16 (the low-precision hierarchy of mg: {dtype: bfloat16}, whose
// periodic levels are the TGV's): the same kernels with T = bf16
// (bf16.cuh), every operation of the twin done in float32 and rounded to
// bfloat16, as PyTorch does on the twin's bfloat16 tensors; the staging
// copies two-byte values with plain loads and stores.

#include "pcr.cuh"
#include "pcr_warp.cuh"

namespace {

// rows a lane holds at most, and the longest line of the register paths
constexpr int kMaxRows = 8;
constexpr int kWarpLine = 32 * kMaxRows;
// lines (one warp each) of a warp_rows block and of a warp_tiles block
constexpr int kRowsWarps = 8;
constexpr int kTileLines = 8;

enum Path { kBlock = 0, kWarpRows = 1, kWarpTiles = 2 };

// warp_rows: lines along the contiguous axis, one warp a line.  F: the
// lines fill the warp (n = 32 R), so that the rows out of range, and the
// number of passes, are known at compile time.
template <typename T, int R, bool F>
__global__ void __launch_bounds__(32 * kRowsWarps)
    pcr_warp_rows(const T* __restrict__ a, const T* __restrict__ b,
                  const T* __restrict__ c, const T* __restrict__ d,
                  T* __restrict__ x, long long nlines, int n_line,
                  int steps_line) {
  const int n = F ? 32 * R : n_line;
  const int steps = F ? 5 + log2i(R) : steps_line;
  const int lane = threadIdx.x & 31;
  const long long line =
      (long long)blockIdx.x * kRowsWarps + (threadIdx.x >> 5);
  if (line >= nlines) return;  // the whole warp: no barrier follows
  const long long base = line * n;
  a += base;
  b += base;
  c += base;
  d += base;
  x += base;
  T ra[R], rb[R], rc[R], rd[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = 32 * r + lane;
    const bool in = i < n;
    ra[r] = in && i > 0 ? a[i] : T(0);
    rb[r] = in ? b[i] : T(1);
    rc[r] = in && i < n - 1 ? c[i] : T(0);
    rd[r] = in ? d[i] : T(0);
  }
  warp_passes<T, R, 0>(ra, rb, rc, rd, n, steps, lane);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = 32 * r + lane;
    if (i < n) x[i] = rd[r] / rb[r];
  }
}

// warp_tiles: lines along a strided axis (row stride s_line); block
// (o, t) solves the W lines o * s_outer + t * W + w, w < W, of the n2
// next to each other along the contiguous axis.  F as for warp_rows.
template <typename T, int R, bool F>
__global__ void __launch_bounds__(32 * kTileLines)
    pcr_warp_tiles(const T* __restrict__ a, const T* __restrict__ b,
                   const T* __restrict__ c, const T* __restrict__ d,
                   T* __restrict__ x, int n_line, int steps_line, int n2,
                   int tiles, long long s_outer, int s_line) {
  constexpr int W = kTileLines;
  constexpr int P = W + 1;  // padded row of the tile
  const int n = F ? 32 * R : n_line;
  const int steps = F ? 5 + log2i(R) : steps_line;
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = n * P;
  T* ta = reinterpret_cast<T*>(smem);
  T* tb = ta + m;
  T* tc = tb + m;
  T* td = tc + m;
  const int o = blockIdx.x / tiles;  // the block's one division
  const int w0 = (blockIdx.x - o * tiles) * W;
  const long long base = (long long)o * s_outer + w0;
  a += base;
  b += base;
  c += base;
  d += base;
  x += base;
  const int valid = min(W, n2 - w0);  // lines of the tile in the batch
  for (int e = threadIdx.x; e < n * W; e += blockDim.x) {
    const int row = e / W;
    const int w = e % W;
    const int sid = row * P + w;
    if (w < valid) {
      const int off = row * s_line + w;
      copy_async(ta + sid, a + off);
      copy_async(tb + sid, b + off);
      copy_async(tc + sid, c + off);
      copy_async(td + sid, d + off);
    } else {
      ta[sid] = T(0);
      tb[sid] = T(1);
      tc[sid] = T(0);
      td[sid] = T(0);
    }
  }
  wait_async();
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int col = threadIdx.x >> 5;  // the warp's line
  T ra[R], rb[R], rc[R], rd[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = 32 * r + lane;
    const bool in = i < n;
    const int s = i * P + col;
    ra[r] = in && i > 0 ? ta[s] : T(0);
    rb[r] = in ? tb[s] : T(1);
    rc[r] = in && i < n - 1 ? tc[s] : T(0);
    rd[r] = in ? td[s] : T(0);
  }
  warp_passes<T, R, 0>(ra, rb, rc, rd, n, steps, lane);
  // each warp reads and writes only its own column of td
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = 32 * r + lane;
    if (i < n) td[i * P + col] = rd[r] / rb[r];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n * W; e += blockDim.x) {
    const int row = e / W;
    const int w = e % W;
    if (w < valid) x[row * s_line + w] = td[row * P + w];
  }
}

// The block path (pcr.cuh): lines of up to pcr::kMaxLine rows.
template <typename T>
__global__ void __launch_bounds__(pcr::kMaxThreads)
    tridiag_pcr_kernel(const T* __restrict__ a, const T* __restrict__ b,
                       const T* __restrict__ c, const T* __restrict__ d,
                       T* __restrict__ x, pcr::Lines g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = g.n * g.lt;
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + m;
  T* sc = sb + m;
  T* sd = sc + m;
  pcr::Slot slots[pcr::kPerThread];
#pragma unroll
  for (int r = 0; r < pcr::kPerThread; ++r) {
    long long line;
    slots[r] = pcr::slot(g, threadIdx.x + r * blockDim.x, &line);
    const pcr::Slot& s = slots[r];
    if (!s.active) continue;
    if (s.valid) {
      sa[s.sid] = s.row == 0 ? T(0) : a[s.offset];
      sb[s.sid] = b[s.offset];
      sc[s.sid] = s.row == g.n - 1 ? T(0) : c[s.offset];
      sd[s.sid] = d[s.offset];
    } else {
      sa[s.sid] = T(0);
      sb[s.sid] = T(1);
      sc[s.sid] = T(0);
      sd[s.sid] = T(0);
    }
  }
  __syncthreads();
  pcr::passes<T>(g, slots, g.steps, sa, sb, sc, sd);
#pragma unroll
  for (int r = 0; r < pcr::kPerThread; ++r) {
    const pcr::Slot& s = slots[r];
    if (s.valid) x[s.offset] = sd[s.sid] / sb[s.sid];
  }
}

template <typename T>
int launch_block(const T* a, const T* b, const T* c, const T* d, T* x,
                 const pcr::Lines& g, int lines, cudaStream_t stream) {
  if (lines != g.lt) return (int)cudaErrorInvalidValue;
  static bool allowed = false;
  if (!allowed) {
    cudaError_t err = pcr::allow_shared(tridiag_pcr_kernel<T>, sizeof(T));
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  tridiag_pcr_kernel<T><<<(unsigned)pcr::blocks(g), g.threads,
                          pcr::shared_bytes<T>(g), stream>>>(a, b, c, d, x, g);
  return (int)cudaGetLastError();
}

template <typename T, int R, bool F>
int launch_warp(const T* a, const T* b, const T* c, const T* d, T* x,
                const pcr::Lines& g, int path, int lines,
                cudaStream_t stream) {
  if (path == kWarpRows) {
    if (lines != kRowsWarps) return (int)cudaErrorInvalidValue;
    const long long blocks = (g.nlines + kRowsWarps - 1) / kRowsWarps;
    pcr_warp_rows<T, R, F><<<(unsigned)blocks, 32 * kRowsWarps, 0, stream>>>(
        a, b, c, d, x, g.nlines, g.n, g.steps);
    return (int)cudaGetLastError();
  }
  constexpr int W = kTileLines;
  if (lines != W) return (int)cudaErrorInvalidValue;
  static bool allowed = false;
  if (!allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        pcr_warp_tiles<T, R, F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(4 * sizeof(T) * kWarpLine * (W + 1)));
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  const long long n0 = g.shape[0], n1 = g.shape[1], n2 = g.shape[2];
  const int tiles = (int)((n2 + W - 1) / W);
  const long long outer = g.axis == 1 ? n0 : n1;
  const long long s_outer = g.axis == 1 ? n1 * n2 : n2;
  const size_t bytes = 4 * sizeof(T) * (size_t)g.n * (W + 1);
  pcr_warp_tiles<T, R, F><<<(unsigned)(outer * tiles), 32 * W, bytes,
                            stream>>>(a, b, c, d, x, g.n, g.steps, (int)n2,
                                      tiles, s_outer, (int)g.s_line);
  return (int)cudaGetLastError();
}

template <typename T, int R>
int launch_rows(const T* a, const T* b, const T* c, const T* d, T* x,
                const pcr::Lines& g, int path, int lines,
                cudaStream_t stream) {
  if (g.n == 32 * R)
    return launch_warp<T, R, true>(a, b, c, d, x, g, path, lines, stream);
  return launch_warp<T, R, false>(a, b, c, d, x, g, path, lines, stream);
}

// Checks the plan against the shape and launches it: `path` (Path),
// `rows` (R of the register paths) and `lines` (lines a block) come from
// linalg/cuda_pcr.py launch_plan.
template <typename T>
int launch(const T* a, const T* b, const T* c, const T* d, T* x, long long n0,
           long long n1, long long n2, int axis, int path, int rows,
           int lines, cudaStream_t stream) {
  pcr::Lines g;
  if (!pcr::make_lines(n0, n1, n2, axis, &g)) return (int)cudaErrorInvalidValue;
  if (path == kBlock) return launch_block<T>(a, b, c, d, x, g, lines, stream);
  const bool fits = g.n <= 32 * rows && n0 * n1 * n2 < (1LL << 31) &&
                    (path == kWarpRows) == (axis == 2) &&
                    (path == kWarpRows || path == kWarpTiles);
  if (!fits) return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 1: return launch_rows<T, 1>(a, b, c, d, x, g, path, lines, stream);
    case 2: return launch_rows<T, 2>(a, b, c, d, x, g, path, lines, stream);
    case 4: return launch_rows<T, 4>(a, b, c, d, x, g, path, lines, stream);
    case 8: return launch_rows<T, 8>(a, b, c, d, x, g, path, lines, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, 0 on success, cudaErrorInvalidValue for a shape or plan the
// kernels do not take.  A 2D array is passed as n0 = 1 with axis 1 or 2.
extern "C" int tridiag_pcr_f32(const float* a, const float* b, const float* c,
                               const float* d, float* x, long long n0,
                               long long n1, long long n2, int axis, int path,
                               int rows, int lines, void* stream) {
  return launch<float>(a, b, c, d, x, n0, n1, n2, axis, path, rows, lines,
                       (cudaStream_t)stream);
}

extern "C" int tridiag_pcr_bf16(const unsigned short* a,
                                const unsigned short* b,
                                const unsigned short* c,
                                const unsigned short* d, unsigned short* x,
                                long long n0, long long n1, long long n2,
                                int axis, int path, int rows, int lines,
                                void* stream) {
  return launch<bf16>(as_bf16(a), as_bf16(b), as_bf16(c), as_bf16(d),
                      as_bf16(x), n0, n1, n2, axis, path, rows, lines,
                      (cudaStream_t)stream);
}

extern "C" int tridiag_pcr_f64(const double* a, const double* b,
                               const double* c, const double* d, double* x,
                               long long n0, long long n1, long long n2,
                               int axis, int path, int rows, int lines,
                               void* stream) {
  return launch<double>(a, b, c, d, x, n0, n1, n2, axis, path, rows, lines,
                        (cudaStream_t)stream);
}
