// One damped line-Jacobi sweep of the multigrid smoother along one axis
// of a non-periodic level (kernels K4/K5 of the port).
//
// Replaces petibm_tpu/linalg/pallas_sweep.py:150 fused_sweep (K4, the
// whole-array Pallas kernel, body _make_sweep_kernel) and :230
// fused_sweep_blocked (K5, the same sweep gridded along a batch axis,
// whose coupling the caller adds to the right side first).  The K4/K5
// split sizes the arrays to TPU VMEM; here one kernel serves both and
// builds every axis's coupling itself.  The sweep solves, for each line
// along the line direction d, the area-rescaled system of sweep_aux
// (petibm_tpu_torch/linalg/cuda_sweep.py):
//
//   sub/super-diagonal  a_lo[i] = -c_d[i],  c_hi[i] = -c_d[i+1]
//   diagonal            diag_line[i] + w_line[i] * s_batch[line]
//   right side          rhs * inv_area[line]
//                       + sum_e (w_line[i] * inv_w_e) * (c_lo_e phi[-1] + c_hi_e phi[+1])
//
// over the other axes e in descending order, by PCR, then writes
// out = phi + omega * (x - phi).  Every value is computed with the plain
// twin's formula in its order (fused_sweep_ref; built with --fmad=false),
// so the result equals the twin's on every path (max |kernel - twin| = 0;
// an exact zero may differ in sign).
//
// Bound, at the sphere's finest level (130 x 130 x 160): device-memory
// bandwidth.  phi and rhs are read once and out written once, 32.4 MB in
// float32: 9.7 us at 3.35 TB/s (19.4 us in float64); the arithmetic, 131
// operations a row (7 + 6 per other axis + 14 per PCR pass, 8 passes), is
// 5.3 us at 67 TFLOP/s.  The neighbour reads of phi along the other axes
// hit L2, and the 1D factors and batch-shaped scalars are a few KB.
//
// What binds this design is the passes' instruction issue and latency,
// and in them the twin's two IEEE divisions a row a pass: with the passes
// compiled out the kernel takes about a quarter of its time, with
// approximate division about half (scripts/bench_torch_sweep.py, variants nopass and
// fastdiv).  `/` in float32 is a reciprocal, five FMAs, a range check and
// a branch to a slow path, which PCR's decaying off-diagonals do take:
// on the sphere's finest level the middle passes hold numerators under
// 2^-124 and subnormal quotients in most warps.  The float32 register
// paths therefore divide with pcr_warp.cuh's quotient_fast (the same
// reciprocal and FMAs, no check) where a warp's operands are all in
// range, else quotient_scaled (tiny numerators scaled, the result
// rounded once onto the subnormal grid), else `/`: the same values.
//
// Design.  The wrapper (linalg/cuda_sweep.py launch_plan) hands in a plan:
//
// - Register paths (pcr_warp.cuh), lines of up to 32 kMaxRows = 160 rows:
//   one warp holds one line, row i = 32 r + lane in register r (R rows a
//   lane, R in {1, 2, 3, 4, 5}: the sphere's 160- and 130-row lines fill
//   R = 5 to 100% and 81%; R = 8 filled 63% and 51% and took 78% / 46%
//   more time there, and lost to the block path at the flagship's 225-row
//   level (scripts/bench_torch_sweep.py), so longer lines take the block
//   path).  The rows past the line
//   hold b = 1, a = c = d = 0 through every pass, which is what the twin
//   reads out of range, so the passes take the line as 32 R rows and their
//   range tests fold at compile time.  The line scalars (inv_area, s_batch and each other axis's c_lo, c_hi, inv_w at
//   the line's batch coordinate) are loaded once a lane, the wall
//   predicates are uniform across the warp, and the 1D factors are read by
//   row.
//   * warp_rows (line axis 2, contiguous): each lane loads its rows of phi
//     and rhs, and phi's neighbours at -+ the batch strides, 128 bytes a
//     register; it keeps its rows of phi in registers for the update.
//   * warp_tiles (line axes 0 and 1): a block sweeps W lines next to each
//     other along the contiguous axis, W = 16 in batches of at least
//     16384 lines (the sphere's finest level), else 8.  It stages with
//     cp.async phi with one halo column each side (W + 2 columns, padded
//     to W + 3), rhs, and phi at the outer batch coordinate -+ 1, in rows
//     of W values (one or two 32-byte sectors in float32) padded to W + 1
//     columns, so that a warp reading its line (a column) touches 32
//     banks.  The couplings along the contiguous axis come from the halo,
//     the outer ones from their tiles; the update goes back through the
//     rhs tile: two block barriers a launch.
//   One division a warp or a block; offsets in 32 bits (the plan takes
//   these paths only for arrays of fewer than 2^31 values).
// - Block path (pcr.cuh, the first design), lines of up to pcr::kMaxLine =
//   4096 rows, for lines of more than 160 rows: a block holds whole lines
//   in shared memory and runs the passes there; each thread builds its
//   values' right sides while loading.  Its 1024-thread blocks hold it to
//   64 registers a thread.  The flagship's 450- and 225-row levels take it.
//
// bfloat16 (the low-precision hierarchy of mg: {dtype: bfloat16}): the
// same kernels with T = bf16 (bf16.cuh), every operation of the twin done
// in float32 and rounded to bfloat16, as PyTorch does on the twin's
// bfloat16 tensors; omega is taken in float32 (opmath_t), as PyTorch takes
// a Python float.  The passes divide with `/` (the float32 quotient of two
// bfloat16 values, rounded once to bfloat16).  Two-byte values move half
// the bytes; the warp_tiles staging copies them with plain loads and
// stores (cp.async takes 4 bytes or more).
//
// Measured on an H100 80GB HBM3 at 700 W, median device time a sweep
// (chip_smoke.py phase 2; the variants by scripts/bench_torch_sweep.py):
// the sphere's finest level in float32 takes 79.49 us on axis 2
// (warp_rows, R = 5) and 98.31 / 98.36 us on axes 1 / 0 (warp_tiles,
// R = 5, W = 16), 10-12% of its bound, against 213.94 / 205.61 / 206.14
// us on the block path; in float64 127.21 / 189.70 / 190.66 us against
// 1287-1294.  Its level 1 takes 14.41 / 17.25 / 17.12 us, the flagship's
// 450^2 level 22.64 / 23.71 us (block path).

#include "pcr.cuh"
#include "pcr_warp.cuh"

namespace {

// rows a lane holds at most on the register paths
constexpr int kMaxRows = 5;
// lines (one warp each) of a warp_rows block; a warp_tiles block takes
// W = 8 or 16 (the plan's choice)
constexpr int kRowsWarps = 8;

enum Path { kBlock = 0, kWarpRows = 1, kWarpTiles = 2 };

template <typename T>
struct Factors {
  const T* a_lo;       // (n,) along the line
  const T* c_hi;       // (n,)
  const T* diag_line;  // (n,)
  const T* w_line;     // (n,)
  const T* inv_area;   // (nlines,) batch-shaped
  const T* s_batch;    // (nlines,)
  const T* c_lo[3];    // per array axis: the coupling factors (null on
  const T* c_hi_e[3];  // the line axis and on an absent 2D axis)
  const T* inv_w[3];
};

// One other axis's factors at a line's batch coordinate ie (of `size`),
// and whether phi has a neighbour below and above along it.
template <typename T>
struct Coupling {
  T c_lo, c_hi, inv_w;
  bool lo, hi;
};

template <typename T>
__device__ __forceinline__ Coupling<T> coupling(const T* c_lo, const T* c_hi,
                                                const T* inv_w, int ie,
                                                int size) {
  return {c_lo[ie], c_hi[ie], inv_w[ie], ie > 0, ie < size - 1};
}

// bb + (w_line * inv_w_e) * (c_lo_e * lo + c_hi_e * hi): the twin's
// order, lo and hi already 0 past a wall
template <typename T>
__device__ __forceinline__ T add_coupling(T bb, T w_line, const Coupling<T>& e,
                                          T lo, T hi) {
  const T couple = e.c_lo * lo + e.c_hi * hi;
  return bb + (w_line * e.inv_w) * couple;
}

// warp_rows: lines along the contiguous axis 2 of an (n0, n1, n) array,
// one warp a line.
template <typename T, int R>
__global__ void __launch_bounds__(32 * kRowsWarps)
    sweep_warp_rows(const T* __restrict__ phi, const T* __restrict__ rhs,
                    T* __restrict__ out, Factors<T> f, int n0, int n1, int n,
                    int steps, opmath_t<T> omega) {
  const int lane = threadIdx.x & 31;
  const int line = blockIdx.x * kRowsWarps + (threadIdx.x >> 5);
  if (line >= n0 * n1) return;  // the whole warp: no barrier follows
  const int z = line / n1;      // the warp's one division
  const int y = line - z * n1;
  const int base = line * n;
  const T inv_area = f.inv_area[line];
  const T s_batch = f.s_batch[line];
  // the other axes in descending order: 1 (stride n), then 0 (n1 n)
  const bool has_y = f.c_lo[1] != nullptr;
  const bool has_z = f.c_lo[0] != nullptr;
  Coupling<T> cy{}, cz{};
  if (has_y) cy = coupling(f.c_lo[1], f.c_hi_e[1], f.inv_w[1], y, n1);
  if (has_z) cz = coupling(f.c_lo[0], f.c_hi_e[0], f.inv_w[0], z, n0);
  const int sy = n, sz = n1 * n;
  T ra[R], rb[R], rc[R], rd[R], rp[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = 32 * r + lane;
    if (i < n) {
      const int at = base + i;
      const T w_line = f.w_line[i];
      T bb = rhs[at] * inv_area;
      if (has_y)
        bb = add_coupling(bb, w_line, cy, cy.lo ? phi[at - sy] : T(0),
                          cy.hi ? phi[at + sy] : T(0));
      if (has_z)
        bb = add_coupling(bb, w_line, cz, cz.lo ? phi[at - sz] : T(0),
                          cz.hi ? phi[at + sz] : T(0));
      ra[r] = i > 0 ? f.a_lo[i] : T(0);
      rb[r] = f.diag_line[i] + w_line * s_batch;
      rc[r] = i < n - 1 ? f.c_hi[i] : T(0);
      rd[r] = bb;
      rp[r] = phi[at];
    } else {
      ra[r] = T(0);
      rb[r] = T(1);
      rc[r] = T(0);
      rd[r] = T(0);
      rp[r] = T(0);
    }
  }
  // the line taken as 32 R rows (the design note)
  warp_passes<T, R, 0, true>(ra, rb, rc, rd, 32 * R, steps, lane);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = 32 * r + lane;
    if (i < n) {
      const T x = rd[r] / rb[r];
      out[base + i] = rp[r] + omega * (x - rp[r]);
    }
  }
}

// Shared memory of a warp_tiles block of W lines: the phi tile
// (n x (W + 3)), the rhs tile and, when the outer batch axis couples, its
// two neighbour tiles (n x (W + 1) each).
template <typename T, int W>
size_t tile_bytes(int n, bool outer_coupling) {
  return sizeof(T) * (size_t)n * ((W + 3) + (W + 1) * (outer_coupling ? 3 : 1));
}

// warp_tiles: lines along a strided axis (row stride s_line) of an array
// whose last axis has n2 values; the outer batch axis (array axis e_out,
// `outer` values, stride s_outer) couples unless its factors are null.
// Block (o, t) sweeps the W lines o * s_outer + t * W + w, w < W.
template <typename T, int R, int W>
__global__ void __launch_bounds__(32 * W)
    sweep_warp_tiles(const T* __restrict__ phi, const T* __restrict__ rhs,
                     T* __restrict__ out, Factors<T> f, int n, int steps,
                     int n2, int tiles, int outer, int s_outer, int s_line,
                     int e_out, opmath_t<T> omega) {
  constexpr int P = W + 1;  // padded row of the rhs and neighbour tiles
  constexpr int Q = W + 3;  // padded row of the phi tile with its halo
  extern __shared__ __align__(16) unsigned char smem[];
  T* tp = reinterpret_cast<T*>(smem);  // column w + 1: phi at w0 + w
  T* tr = tp + n * Q;                  // rhs, then the update
  T* tl = tr + n * P;                  // phi at outer coordinate o - 1
  T* th = tl + n * P;                  // phi at o + 1
  const int o = blockIdx.x / tiles;    // the block's one division
  const int w0 = (blockIdx.x - o * tiles) * W;
  const int base = o * s_outer + w0;
  const int valid = min(W, n2 - w0);   // lines of the tile in the batch
  const T* c_lo_o = e_out == 0 ? f.c_lo[0] : f.c_lo[1];
  const T* c_hi_o = e_out == 0 ? f.c_hi_e[0] : f.c_hi_e[1];
  const T* inv_w_o = e_out == 0 ? f.inv_w[0] : f.inv_w[1];
  const bool has_o = c_lo_o != nullptr;
  const bool o_lo = has_o && o > 0;
  const bool o_hi = has_o && o < outer - 1;
  // phi with one halo column each side, zero past the walls (the twin's
  // shift fills 0 there)
  for (int e = threadIdx.x; e < n * (W + 2); e += blockDim.x) {
    const int row = e / (W + 2);
    const int w = e - row * (W + 2) - 1;
    T* dst = tp + row * Q + w + 1;
    if (w0 + w >= 0 && w0 + w < n2)
      copy_async(dst, phi + base + row * s_line + w);
    else
      *dst = T(0);
  }
  for (int e = threadIdx.x; e < n * W; e += blockDim.x) {
    const int row = e / W;
    const int w = e % W;
    if (w < valid) {
      const int off = base + row * s_line + w;
      const int sid = row * P + w;
      copy_async(tr + sid, rhs + off);
      if (o_lo) copy_async(tl + sid, phi + off - s_outer);
      if (o_hi) copy_async(th + sid, phi + off + s_outer);
    }
  }
  wait_async();
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int col = threadIdx.x >> 5;  // the warp's line
  if (col < valid) {
    const int x = w0 + col;
    const int line = o * n2 + x;
    const T inv_area = f.inv_area[line];
    const T s_batch = f.s_batch[line];
    // the other axes in descending order: 2 (the halo), then e_out
    const Coupling<T> cx =
        coupling(f.c_lo[2], f.c_hi_e[2], f.inv_w[2], x, n2);
    Coupling<T> co{};
    if (has_o) co = coupling(c_lo_o, c_hi_o, inv_w_o, o, outer);
    T ra[R], rb[R], rc[R], rd[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = 32 * r + lane;
      if (i < n) {
        const int s = i * P + col;
        const T* p = tp + i * Q + col;  // phi at x - 1, x, x + 1
        const T w_line = f.w_line[i];
        T bb = tr[s] * inv_area;
        bb = add_coupling(bb, w_line, cx, p[0], p[2]);
        if (has_o)
          bb = add_coupling(bb, w_line, co, o_lo ? tl[s] : T(0),
                            o_hi ? th[s] : T(0));
        ra[r] = i > 0 ? f.a_lo[i] : T(0);
        rb[r] = f.diag_line[i] + w_line * s_batch;
        rc[r] = i < n - 1 ? f.c_hi[i] : T(0);
        rd[r] = bb;
      } else {
        ra[r] = T(0);
        rb[r] = T(1);
        rc[r] = T(0);
        rd[r] = T(0);
      }
    }
    // the line taken as 32 R rows (the design note)
    warp_passes<T, R, 0, true>(ra, rb, rc, rd, 32 * R, steps, lane);
    // each warp reads and writes only its own column of the rhs tile
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = 32 * r + lane;
      if (i < n) {
        const T p = tp[i * Q + col + 1];
        const T x_i = rd[r] / rb[r];
        tr[i * P + col] = p + omega * (x_i - p);
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n * W; e += blockDim.x) {
    const int row = e / W;
    const int w = e % W;
    if (w < valid) out[base + row * s_line + w] = tr[row * P + w];
  }
}

// The block path (pcr.cuh): lines of up to pcr::kMaxLine rows.
template <typename T>
__global__ void __launch_bounds__(pcr::kMaxThreads)
    sweep_block(const T* __restrict__ phi, const T* __restrict__ rhs,
                T* __restrict__ out, Factors<T> f, pcr::Lines g,
                opmath_t<T> omega) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = g.n * g.lt;
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + m;
  T* sc = sb + m;
  T* sd = sc + m;
  pcr::Slot slots[pcr::kPerThread];
  T p0[pcr::kPerThread];
#pragma unroll
  for (int r = 0; r < pcr::kPerThread; ++r) {
    long long line;
    slots[r] = pcr::slot(g, threadIdx.x + r * blockDim.x, &line);
    const pcr::Slot& s = slots[r];
    p0[r] = T(0);
    if (!s.active) continue;
    if (!s.valid) {
      sa[s.sid] = T(0);
      sb[s.sid] = T(1);
      sc[s.sid] = T(0);
      sd[s.sid] = T(0);
      continue;
    }
    // the value's coordinates along the batch axes o0 and o1
    const long long i_o0 = line / g.inner;
    const long long i_o1 = line % g.inner;
    const T p = phi[s.offset];
    p0[r] = p;
    const T w_line = f.w_line[s.row];
    T bb = rhs[s.offset] * f.inv_area[line];
#pragma unroll
    for (int e = 2; e >= 0; --e) {
      if (e == g.axis || f.c_lo[e] == nullptr) continue;
      const long long ie = e == g.o0 ? i_o0 : i_o1;
      const long long se = g.stride[e];
      const T lo = ie > 0 ? phi[s.offset - se] : T(0);
      const T hi = ie < g.shape[e] - 1 ? phi[s.offset + se] : T(0);
      const T couple = f.c_lo[e][ie] * lo + f.c_hi_e[e][ie] * hi;
      bb = bb + (w_line * f.inv_w[e][ie]) * couple;
    }
    sa[s.sid] = f.a_lo[s.row];
    sb[s.sid] = f.diag_line[s.row] + w_line * f.s_batch[line];
    sc[s.sid] = f.c_hi[s.row];
    sd[s.sid] = bb;
  }
  __syncthreads();
  pcr::passes<T>(g, slots, g.steps, sa, sb, sc, sd);
#pragma unroll
  for (int r = 0; r < pcr::kPerThread; ++r) {
    const pcr::Slot& s = slots[r];
    if (s.valid) {
      const T xs = sd[s.sid] / sb[s.sid];
      out[s.offset] = p0[r] + omega * (xs - p0[r]);
    }
  }
}

template <typename T>
int launch_block(const T* phi, const T* rhs, T* out, const Factors<T>& f,
                 const pcr::Lines& g, int lines, opmath_t<T> omega,
                 cudaStream_t stream) {
  if (lines != g.lt) return (int)cudaErrorInvalidValue;
  static bool allowed = false;
  if (!allowed) {
    cudaError_t err = pcr::allow_shared(sweep_block<T>, sizeof(T));
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  sweep_block<T><<<(unsigned)pcr::blocks(g), g.threads,
                   pcr::shared_bytes<T>(g), stream>>>(phi, rhs, out, f, g,
                                                      omega);
  return (int)cudaGetLastError();
}

template <typename T, int R, int W>
int launch_tiles(const T* phi, const T* rhs, T* out, const Factors<T>& f,
                 const pcr::Lines& g, opmath_t<T> omega,
                 cudaStream_t stream) {
  static bool allowed = false;
  if (!allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        sweep_warp_tiles<T, R, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tile_bytes<T, W>(32 * R, true));
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  const long long n2 = g.shape[2];
  const int tiles = (int)((n2 + W - 1) / W);
  // the outer batch axis: 0 for lines along axis 1, 1 for lines along 0
  const int e_out = g.axis == 1 ? 0 : 1;
  const long long outer = g.shape[e_out];
  const size_t bytes = tile_bytes<T, W>(g.n, f.c_lo[e_out] != nullptr);
  sweep_warp_tiles<T, R, W><<<(unsigned)(outer * tiles), 32 * W, bytes,
                              stream>>>(phi, rhs, out, f, g.n, g.steps,
                                        (int)n2, tiles, (int)outer,
                                        (int)g.stride[e_out], (int)g.s_line,
                                        e_out, omega);
  return (int)cudaGetLastError();
}

template <typename T, int R>
int launch_warp(const T* phi, const T* rhs, T* out, const Factors<T>& f,
                const pcr::Lines& g, int path, int lines, opmath_t<T> omega,
                cudaStream_t stream) {
  if (path == kWarpRows) {
    if (lines != kRowsWarps) return (int)cudaErrorInvalidValue;
    const long long blocks = (g.nlines + kRowsWarps - 1) / kRowsWarps;
    sweep_warp_rows<T, R><<<(unsigned)blocks, 32 * kRowsWarps, 0, stream>>>(
        phi, rhs, out, f, (int)g.shape[0], (int)g.shape[1], g.n, g.steps,
        omega);
    return (int)cudaGetLastError();
  }
  if (lines == 8) return launch_tiles<T, R, 8>(phi, rhs, out, f, g, omega, stream);
  if (lines == 16) return launch_tiles<T, R, 16>(phi, rhs, out, f, g, omega, stream);
  return (int)cudaErrorInvalidValue;
}

// Checks the plan against the shape and launches it: `path` (Path),
// `rows` (R of the register paths) and `lines` (lines a block) come from
// linalg/cuda_sweep.py launch_plan.
template <typename T>
int launch(const T* phi, const T* rhs, T* out, const T* const* vec,
           long long n0, long long n1, long long n2, int axis, double omega,
           int path, int rows, int lines, cudaStream_t stream) {
  pcr::Lines g;
  if (!pcr::make_lines(n0, n1, n2, axis, &g)) return (int)cudaErrorInvalidValue;
  Factors<T> f;
  f.a_lo = vec[0];
  f.c_hi = vec[1];
  f.diag_line = vec[2];
  f.w_line = vec[3];
  f.inv_area = vec[4];
  f.s_batch = vec[5];
  for (int e = 0; e < 3; ++e) {
    f.c_lo[e] = vec[6 + 3 * e];
    f.c_hi_e[e] = vec[7 + 3 * e];
    f.inv_w[e] = vec[8 + 3 * e];
    if (e != axis && g.shape[e] > 1 &&
        (f.c_lo[e] == nullptr || f.c_hi_e[e] == nullptr || f.inv_w[e] == nullptr))
      return (int)cudaErrorInvalidValue;
  }
  const opmath_t<T> w = static_cast<opmath_t<T>>(omega);
  if (path == kBlock) return launch_block<T>(phi, rhs, out, f, g, lines, w, stream);
  const bool fits = g.n <= 32 * rows && rows <= kMaxRows &&
                    n0 * n1 * n2 < (1LL << 31) &&
                    (path == kWarpRows) == (axis == 2) &&
                    (path == kWarpRows || path == kWarpTiles);
  if (!fits) return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 1: return launch_warp<T, 1>(phi, rhs, out, f, g, path, lines, w, stream);
    case 2: return launch_warp<T, 2>(phi, rhs, out, f, g, path, lines, w, stream);
    case 3: return launch_warp<T, 3>(phi, rhs, out, f, g, path, lines, w, stream);
    case 4: return launch_warp<T, 4>(phi, rhs, out, f, g, path, lines, w, stream);
    case 5: return launch_warp<T, 5>(phi, rhs, out, f, g, path, lines, w, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, 0 on success, cudaErrorInvalidValue for a shape or plan the
// kernel does not take.  `vec` holds 15 device pointers: a_lo, c_hi,
// diag_line, w_line, inv_area, s_batch, then (c_lo, c_hi, inv_w) of array
// axes 0, 1 and 2, null for the line axis and for the absent axis 0 of a
// 2D level (passed as n0 = 1, line axis 1 or 2).
extern "C" int line_sweep_f32(const float* phi, const float* rhs, float* out,
                              const float* const* vec, long long n0,
                              long long n1, long long n2, int axis,
                              double omega, int path, int rows, int lines,
                              void* stream) {
  return launch<float>(phi, rhs, out, vec, n0, n1, n2, axis, omega, path,
                       rows, lines, (cudaStream_t)stream);
}

extern "C" int line_sweep_bf16(const unsigned short* phi,
                               const unsigned short* rhs, unsigned short* out,
                               const unsigned short* const* vec, long long n0,
                               long long n1, long long n2, int axis,
                               double omega, int path, int rows, int lines,
                               void* stream) {
  return launch<bf16>(as_bf16(phi), as_bf16(rhs), as_bf16(out), as_bf16(vec),
                      n0, n1, n2, axis, omega, path, rows, lines,
                      (cudaStream_t)stream);
}

extern "C" int line_sweep_f64(const double* phi, const double* rhs,
                              double* out, const double* const* vec,
                              long long n0, long long n1, long long n2,
                              int axis, double omega, int path, int rows,
                              int lines, void* stream) {
  return launch<double>(phi, rhs, out, vec, n0, n1, n2, axis, omega, path,
                        rows, lines, (cudaStream_t)stream);
}
