// Interpolation E and spreading H of the factor delta engine
// (ibm/interp.py DeltaOp) over each Lagrangian point's window: K = 2 half + 1
// gridlines a direction (5 for Roma et al. 1999, 7 for Peskin 2002).
//
// Replaces no Pallas kernel: the JAX package leaves E and H to XLA as
// dense contractions of (N, n_d) factor rows over whole grid lines
// (petibm_tpu/ibm/interp.py:137-161), and the port first did the same with
// torch.matmul / einsum.  At the sphere's shapes (1963 points, 160 x 130 x
// 130 cells) one E or H was a 10.6 GFLOP product with a 130-160 MB
// intermediate, almost all of it zeros: a point's window holds K^3 = 125
// cells a component.  These kernels read the (N, K) window gridlines and
// weights that the engine makes (``idx``, ``wv``, ``wd``: direction x
// first, shape (dim, N, K), int32 and the field's type) and nothing else.
//
// E (delta_interpolate_*): out[p, c] = sum over the window of
//   u_c[iz, iy, ix] * ((wz * wy) * wx)
// with the volume weights wv, the cells in (kz, ky, kx) order from 0; a
// thread a point and component (one launch: blockIdx.y the component).
// In 2D wz is 1 (1 * wy is wy exactly).
//
// H (delta_spread_*): adds to each cell of component c's window box
//   [scale *] sum over the points p, in point order, of
//   ((f[p, c] * Fz) * Fy) * Fx,   Fd = sum over the window slots k, in
//   order, of (idx_d[p, k] == cell_d ? wd_d[p, k] : 0)
// into the component's array in place (the caller's rhs1 or u*: the fold
// of the step's "rhs1 + H f" and, for B_N order 1, "u* + dt H df").  A
// point whose window misses a cell adds an exact zero there, so skipping
// it changes no bit: the sum starts at +0 and never becomes -0.  No
// atomics: a block owns a tile of the box and gathers; its bits repeat
// from run to run.  The plain twins (ibm/cuda_delta.py interpolate_ref,
// spread_ref) sum in the same order.  Every product and sum is rounded on
// its own (__fmul_rn / __fadd_rn and their double forms, never contracted
// into an FMA; the source is built with --fmad=false besides), so a
// kernel equals its twin bit for bit.
//
// Bound: latency, not bytes.  E reads the cells the windows touch (42 000
// over the sphere's three components) and H reads and writes them: under
// 2 MB, ~0.3-0.5 us at 3.35 TB/s, against 7 and 37 us measured.  Design:
// - E: the thread's 3 K indices and weights in registers; the K^3 loads
//   unrolled and independent, so they are in flight together.  64 threads
//   a block spread the few thousand threads over more SMs.
// - H: one block of 256 threads a tile of the box (16 x 4 x 4 cells in
//   3D, 32 x 8 in 2D), one thread a cell.  The block scans the points in
//   rounds of kCap: a thread tests one point (do its windows meet the
//   tile in every direction?), a ballot and the warps' counts give each
//   hit its slot in point order, and the hit's thread writes f and the
//   tile's factor values Fx, Fy, Fz (TX + TY + TZ of them) into shared
//   memory.  When a round would overflow the kCap slots the block first
//   adds the slots it holds.  So no map is built at set-up, and a moving
//   body's windows, new every step, take the same path (its box is then
//   the whole grid).  The scan bounds H: at the sphere a block runs 16
//   rounds, each a global load and two barriers.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 16): see
// PERF.md section 6, the E/H row.

#include <cuda_runtime.h>

// The C interface's arguments, mirrored by ibm/cuda_delta.py (_Component,
// _Args).  Directions are x, y, z; a 2D launch leaves z's entries 0 (its
// box [0, 1)).
struct DeltaComponent {
  void* field;           // E: u_c, read; H: the array added into
  const int* idx;        // (dim, N, K) window gridlines
  const void* w;         // (dim, N, K) weights: E wv, H wd
  long long stride[3];   // the array's strides in values (x, y, z)
  int lo[3];             // H: the window box [lo, hi) per direction
  int hi[3];
};

struct DeltaArgs {
  void* points;          // E: out (N, dim); H: f (N, dim), both contiguous
  double scale;          // H: the factor of the sum where scaled
  int n_pts;
  int dim;
  int k;
  int scaled;
  DeltaComponent comp[3];
};

namespace {

constexpr int kInterpThreads = 64;
constexpr int kSpreadThreads = 256;
constexpr int kWarps = kSpreadThreads / 32;
// the points a block holds at once (kCap <= kSpreadThreads: a round fits
// the slots after a flush)
constexpr int kCap = 128;

template <typename T>
struct Comp {
  T* field;
  const int* idx;
  const T* w;
  long long stride[3];
  int lo[3];
  int hi[3];
  int tiles[3];
  int first;             // H: the component's first block
};

template <typename T>
struct Params {
  T* points;
  T scale;
  int n_pts;
  int dim;
  int scaled;
  int ncomp;
  Comp<T> comp[3];
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }

template <typename T, int DIM, int K>
__global__ void __launch_bounds__(kInterpThreads)
delta_interpolate(const __grid_constant__ Params<T> p) {
  const int c = blockIdx.y;
  const int i = blockIdx.x * kInterpThreads + threadIdx.x;
  if (i >= p.n_pts) return;
  const Comp<T>& q = p.comp[c];
  const size_t n = p.n_pts;
  int ix[K], iy[K], iz[K];
  T wx[K], wy[K], wz[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    ix[k] = q.idx[i * K + k];
    wx[k] = q.w[i * K + k];
    iy[k] = q.idx[(n + i) * K + k];
    wy[k] = q.w[(n + i) * K + k];
    iz[k] = DIM == 3 ? q.idx[(2 * n + i) * K + k] : 0;
    wz[k] = DIM == 3 ? q.w[(2 * n + i) * K + k] : T(1);
  }
  const T* u = q.field;
  T acc = T(0);
#pragma unroll
  for (int kz = 0; kz < (DIM == 3 ? K : 1); ++kz) {
    const long long oz = iz[kz] * q.stride[2];
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
      const T wzy = mul(wz[kz], wy[ky]);
      const long long ozy = oz + iy[ky] * q.stride[1];
#pragma unroll
      for (int kx = 0; kx < K; ++kx)
        acc = add(acc, mul(__ldg(u + ozy + ix[kx] * q.stride[0]),
                           mul(wzy, wx[kx])));
    }
  }
  p.points[i * p.dim + c] = acc;
}

// Does one of the window's K gridlines lie in [a, b)?
template <int K>
__device__ __forceinline__ bool meets(const int* idx, int a, int b) {
  bool hit = false;
#pragma unroll
  for (int k = 0; k < K; ++k) hit |= idx[k] >= a && idx[k] < b;
  return hit;
}

// The sum over the block's first ``count`` slots, in slot (point) order, of
// a cell's products.
template <typename T, int TX, int TY, int TZ>
__device__ __forceinline__ T accumulate(T acc, int count, const T* s_f,
                                        const T (*s_x)[TX],
                                        const T (*s_y)[TY],
                                        const T (*s_z)[TZ], int tx, int ty,
                                        int tz) {
  for (int j = 0; j < count; ++j)
    acc = add(acc, mul(mul(mul(s_f[j], s_z[j][tz]), s_y[j][ty]), s_x[j][tx]));
  return acc;
}

// The factor value of gridline i: the window's weights on i, in slot order.
template <typename T, int K>
__device__ __forceinline__ T factor(const int* idx, const T* w, int i) {
  T s = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) s = add(s, idx[k] == i ? w[k] : T(0));
  return s;
}

template <typename T, int DIM, int K>
__global__ void __launch_bounds__(kSpreadThreads)
delta_spread(const __grid_constant__ Params<T> p) {
  constexpr int TX = DIM == 3 ? 16 : 32;
  constexpr int TY = DIM == 3 ? 4 : 8;
  constexpr int TZ = DIM == 3 ? 4 : 1;
  static_assert(TX * TY * TZ == kSpreadThreads, "a thread a cell");
  __shared__ T s_f[kCap];
  __shared__ T s_x[kCap][TX];
  __shared__ T s_y[kCap][TY];
  __shared__ T s_z[kCap][TZ];
  __shared__ int s_warp[kWarps];

  int b = blockIdx.x;
  int c = 0;
  while (c + 1 < p.ncomp && b >= p.comp[c + 1].first) ++c;
  const Comp<T>& q = p.comp[c];
  b -= q.first;
  const int x0 = q.lo[0] + (b % q.tiles[0]) * TX;
  b /= q.tiles[0];
  const int y0 = q.lo[1] + (b % q.tiles[1]) * TY;
  const int z0 = q.lo[2] + (b / q.tiles[1]) * TZ;
  const int x1 = min(x0 + TX, q.hi[0]);
  const int y1 = min(y0 + TY, q.hi[1]);
  const int z1 = min(z0 + TZ, q.hi[2]);

  const int t = threadIdx.x;
  const int tx = t % TX, ty = (t / TX) % TY, tz = t / (TX * TY);
  const int lane = t & 31, warp = t >> 5;
  const size_t n = p.n_pts;
  const T* f = p.points;

  T acc = T(0);
  int count = 0;
  for (int base = 0; base < p.n_pts; base += kCap) {
    const int pt = base + t;
    bool hit = false;
    if (t < kCap && pt < p.n_pts)
      hit = meets<K>(q.idx + pt * K, x0, x1)
            && meets<K>(q.idx + (n + pt) * K, y0, y1)
            && (DIM == 2 || meets<K>(q.idx + (2 * n + pt) * K, z0, z1));
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      before += v < warp ? s_warp[v] : 0;
      total += s_warp[v];
    }
    if (count + total > kCap) {  // uniform: every thread read the same
      acc = accumulate<T, TX, TY, TZ>(acc, count, s_f, s_x, s_y, s_z, tx, ty,
                                      tz);
      count = 0;
      __syncthreads();
    }
    if (hit) {
      const int s = count + before + __popc(ballot & ((1u << lane) - 1u));
      s_f[s] = f[pt * p.dim + c];
      const int* ix = q.idx + pt * K;
      const int* iy = q.idx + (n + pt) * K;
      const T* wx = q.w + pt * K;
      const T* wy = q.w + (n + pt) * K;
#pragma unroll
      for (int j = 0; j < TX; ++j) s_x[s][j] = factor<T, K>(ix, wx, x0 + j);
#pragma unroll
      for (int j = 0; j < TY; ++j) s_y[s][j] = factor<T, K>(iy, wy, y0 + j);
#pragma unroll
      for (int j = 0; j < TZ; ++j)
        s_z[s][j] = DIM == 3 ? factor<T, K>(q.idx + (2 * n + pt) * K,
                                            q.w + (2 * n + pt) * K, z0 + j)
                             : T(1);
    }
    count += total;
    __syncthreads();
  }
  acc = accumulate<T, TX, TY, TZ>(acc, count, s_f, s_x, s_y, s_z, tx, ty, tz);

  const int x = x0 + tx, y = y0 + ty, z = z0 + tz;
  if (x < x1 && y < y1 && z < z1) {
    T* cell = q.field + z * q.stride[2] + y * q.stride[1] + x * q.stride[0];
    *cell = add(*cell, p.scaled ? mul(p.scale, acc) : acc);
  }
}

template <typename T>
Params<T> params(const DeltaArgs* a) {
  Params<T> p{};
  p.points = static_cast<T*>(a->points);
  p.scale = static_cast<T>(a->scale);
  p.n_pts = a->n_pts;
  p.dim = a->dim;
  p.scaled = a->scaled;
  p.ncomp = a->dim;
  for (int c = 0; c < a->dim; ++c) {
    const DeltaComponent& s = a->comp[c];
    Comp<T>& q = p.comp[c];
    q.field = static_cast<T*>(s.field);
    q.idx = s.idx;
    q.w = static_cast<const T*>(s.w);
    for (int d = 0; d < 3; ++d) {
      q.stride[d] = s.stride[d];
      q.lo[d] = s.lo[d];
      q.hi[d] = s.hi[d];
    }
  }
  return p;
}

bool valid(const DeltaArgs* a) {
  return a->n_pts >= 0 && (a->dim == 2 || a->dim == 3)
         && (a->k == 5 || a->k == 7);
}

template <typename T>
int launch_interpolate(const DeltaArgs* a, cudaStream_t stream) {
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (a->n_pts == 0) return 0;
  const Params<T> p = params<T>(a);
  const dim3 grid((a->n_pts + kInterpThreads - 1) / kInterpThreads, a->dim);
  if (a->dim == 3 && a->k == 5)
    delta_interpolate<T, 3, 5><<<grid, kInterpThreads, 0, stream>>>(p);
  else if (a->dim == 3)
    delta_interpolate<T, 3, 7><<<grid, kInterpThreads, 0, stream>>>(p);
  else if (a->k == 5)
    delta_interpolate<T, 2, 5><<<grid, kInterpThreads, 0, stream>>>(p);
  else
    delta_interpolate<T, 2, 7><<<grid, kInterpThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_spread(const DeltaArgs* a, cudaStream_t stream) {
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  Params<T> p = params<T>(a);
  const int tile[3] = {a->dim == 3 ? 16 : 32, a->dim == 3 ? 4 : 8,
                       a->dim == 3 ? 4 : 1};
  long long blocks = 0;
  for (int c = 0; c < a->dim; ++c) {
    Comp<T>& q = p.comp[c];
    long long count = 1;
    for (int d = 0; d < 3; ++d) {
      const int extent = q.hi[d] - q.lo[d];
      q.tiles[d] = extent > 0 ? (extent + tile[d] - 1) / tile[d] : 0;
      count *= q.tiles[d];
    }
    q.first = static_cast<int>(blocks);
    blocks += count;
  }
  if (blocks == 0) return 0;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (a->dim == 3 && a->k == 5)
    delta_spread<T, 3, 5><<<grid, kSpreadThreads, 0, stream>>>(p);
  else if (a->dim == 3)
    delta_spread<T, 3, 7><<<grid, kSpreadThreads, 0, stream>>>(p);
  else if (a->k == 5)
    delta_spread<T, 2, 5><<<grid, kSpreadThreads, 0, stream>>>(p);
  else
    delta_spread<T, 2, 7><<<grid, kSpreadThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int delta_interpolate_f32(const DeltaArgs* a, void* stream) {
  return launch_interpolate<float>(a, static_cast<cudaStream_t>(stream));
}

extern "C" int delta_interpolate_f64(const DeltaArgs* a, void* stream) {
  return launch_interpolate<double>(a, static_cast<cudaStream_t>(stream));
}

extern "C" int delta_spread_f32(const DeltaArgs* a, void* stream) {
  return launch_spread<float>(a, static_cast<cudaStream_t>(stream));
}

extern "C" int delta_spread_f64(const DeltaArgs* a, void* stream) {
  return launch_spread<double>(a, static_cast<cudaStream_t>(stream));
}
