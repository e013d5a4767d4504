// Separable pressure Poisson apply (kernel K1 of the port).
//
// Replaces petibm_tpu/operators/pallas_stencil.py:poisson_apply_separable
// (the whole-array Pallas kernel built by make_pallas_poisson from
// separable_aux).  It applies the negated finite-volume pressure operator
// -D B1 G of a non-periodic staggered grid, in 2D or 3D:
//
//   out = sum_d area_d * (a_d * phi - c_lo_d * phi[i-1] - c_hi_d * phi[i+1])
//
// with, for direction d (array axis ndim-1-d; arrays are (z, y, x), x
// fastest), its 1D face coefficients c_d (n_d + 1 entries) and cell widths
// w_d (n_d entries):  a_d = c_d[i] + c_d[i+1], c_lo_d = c_d[i],
// c_hi_d = c_d[i+1], area_d = prod_{e != d} w_e (the lower axis first).
// Neighbours outside the array contribute 0 (at non-periodic walls c_d is
// 0 there anyway).  The sum runs x, then y, then z, each product and sum
// rounded on its own: the order of the plain twin
// (operators/cuda_stencil.py:poisson_apply_separable_ref).  The source is
// built with --fmad=false (_kernels.EXTRA_FLAGS), so no multiply-add is
// contracted into an FMA and both paths equal the twin bit for bit.
//
// Bound: device-memory bandwidth.  The mandatory traffic is read phi and
// write out, 8 B/cell in float32 (1.6 MB at 450^2, 21.6 MB at the sphere's
// 130x130x160 pressure: 6.46 us at 3.35 TB/s); the 26 operations a cell
// take 1.05 us at 67 TFLOP/s; the 1D factors are a few KB.
//
// 3D design: the z march of march.cuh (the design of K2,
// zblocked_helmholtz.cu), with SeparableBody below as the cell.  A thread
// holds cx[i], cx[i+1], their sum and wx[i] of each of its columns and
// cy[j], cy[j+1], their sum and wy[j] of each of its rows for the whole
// march; cz[k], cz[k+1] and wz[k] are one uniform load a plane and their
// sum is formed once a plane.  Every wall is non-periodic, so each halo
// past one holds a literal 0 and nothing outside the array is read.
//
// 2D design: the row march (rowmarch below), the 2D counterpart of the z
// march.  One thread a cell (the cell kernel below, the first design)
// spends on each cell four 64-bit divisions and remainders for its
// coordinates, six loads of 1D factors and two sums of them, and five
// scalar loads of phi.  In the row march a block owns a band of TX
// columns and marches a chunk of ky rows up y, RY rows at a time; each of
// its TX / VX threads owns VX neighbouring columns (read and written as
// one vector, load_x / store_x of march.cuh), each warp a band of 32 VX
// columns.
// - A thread holds its columns' cx[i], cx[i+1], their sum and wx[i] for
//   the whole march, rows j-1 .. j+RY of its columns in registers, and
//   loads the next RY rows while it computes these.  cy[j+1] and wy[j]
//   are uniform loads a row, made a group ahead with the halo (cy[j] is
//   the row below's cy[j+1]); their sum is formed once a row.
// - The x neighbours come from the neighbouring lanes (__shfl_sync); the
//   two columns past a warp's band are one halo load a row, by lane 0 (the
//   column left of the band) and lane 31 (right of it).  Past a wall a
//   neighbour is a literal 0 and is never read; a lane past nx holds 0, so
//   the last column's right neighbour is 0 too.  No block barrier, no
//   shared memory.
// - Coordinates come from blockIdx, threadIdx and the march counter: no
//   integer division per cell; offsets are 32-bit.
// The plan (operators/cuda_stencil.py row_plan) views the field's groups
// of RY rows as planes of one row, a z march of the tile (TX, 1, RY, VX):
// the chunks fill one wave of the card's resident blocks (the occupancy
// calculator, through the resident entries below).  At 450^2 and 512^2
// that is one row a warp (ROW_TILES has RY = 1): a field of 0.8-1 MB
// sits in L2, every apply is one round of loads, and longer marches
// (more rows a warp, RY 2 or 4 rows at a time, 1-8 warps a band) were at
// most 6-8% faster in float32 and float64 and slower in bfloat16
// (scripts/bench_torch_stencil.py --k1-2d).  What holds it is the launch:
// on an H100 at 700 W an apply at 450^2 in float32 took 3.1-3.2 us where
// an empty kernel took 1.8-1.9 and copy_ of the field 2.5-2.7, back to
// back.
// The cell kernel, the first design of both paths, stays behind the C
// entries poisson_apply_separable_cells_*; only chip_smoke.py and
// scripts/bench_torch_stencil.py call it, to time it beside the marches.
//
// bfloat16 (the level-0 residual of the mixed-precision V-cycle, mg:
// {dtype: bfloat16}): the same kernels with T = bf16 (bf16.cuh), each
// product and sum done in float32 and rounded to bfloat16 in the twin's
// order, as PyTorch does on the twin's bfloat16 tensors; the march moves
// two values a thread as one 4-byte load and store.
//
// Measured on an H100 80GB HBM3 at 700 W, median device time an apply
// (chip_smoke.py phase 2): see PERF.md section 6, K1 row.

#include <cuda_runtime.h>

#include "march.cuh"

namespace {

template <typename T, int DIM>
__global__ void poisson_apply_separable_kernel(
    const T* __restrict__ phi, T* __restrict__ out,
    const T* __restrict__ cx, const T* __restrict__ wx,
    const T* __restrict__ cy, const T* __restrict__ wy,
    const T* __restrict__ cz, const T* __restrict__ wz,
    long long nz, long long ny, long long nx) {
  const long long ncell = nz * ny * nx;
  const long long plane = ny * nx;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < ncell; idx += (long long)gridDim.x * blockDim.x) {
    const long long i = idx % nx;
    const long long j = (idx / nx) % ny;
    const long long k = idx / plane;
    const T p = phi[idx];

    // direction x (d = 0): area = w_y (* w_z)
    T area = wy[j];
    if (DIM == 3) area = area * wz[k];
    T lo = i > 0 ? phi[idx - 1] : T(0);
    T hi = i < nx - 1 ? phi[idx + 1] : T(0);
    T term = (cx[i] + cx[i + 1]) * p - cx[i] * lo - cx[i + 1] * hi;
    T acc = area * term;

    // direction y (d = 1): area = w_x (* w_z)
    area = wx[i];
    if (DIM == 3) area = area * wz[k];
    lo = j > 0 ? phi[idx - nx] : T(0);
    hi = j < ny - 1 ? phi[idx + nx] : T(0);
    term = (cy[j] + cy[j + 1]) * p - cy[j] * lo - cy[j + 1] * hi;
    acc += area * term;

    if (DIM == 3) {
      // direction z (d = 2): area = w_x * w_y
      area = wx[i] * wy[j];
      lo = k > 0 ? phi[idx - plane] : T(0);
      hi = k < nz - 1 ? phi[idx + plane] : T(0);
      term = (cz[k] + cz[k + 1]) * p - cz[k] * lo - cz[k + 1] * hi;
      acc += area * term;
    }
    out[idx] = acc;
  }
}

// The cell of K1 in the march, in the twin's order.
template <typename T>
struct SeparableBody {
  struct Params {
    const T *cx, *wx, *cy, *wy, *cz, *wz;
  };
  // an axis's factors at one index: c[n], c[n+1], their sum, and w[n]
  struct Axis {
    T lo, hi, sum, w;
  };
  using X = Axis;
  using Y = Axis;
  using Z = Axis;

  static __device__ __forceinline__ Axis at(const T* c, const T* w, int n) {
    const T lo = ldg(c + n), hi = ldg(c + n + 1);
    return {lo, hi, lo + hi, ldg(w + n)};
  }
  static __device__ __forceinline__ X x_at(const Params& p, int i) {
    return at(p.cx, p.wx, i);
  }
  static __device__ __forceinline__ Y y_at(const Params& p, int j) {
    return at(p.cy, p.wy, j);
  }
  static __device__ __forceinline__ Z z_at(const Params& p, int k) {
    return at(p.cz, p.wz, k);
  }
  // one direction: area * (((lo + hi) * c - lo * below) - hi * above)
  static __device__ __forceinline__ T term(const Axis& a, T area, T c,
                                           T below, T above) {
    return area * ((a.sum * c - a.lo * below) - a.hi * above);
  }
  static __device__ __forceinline__ T apply(const Z& z, const Y& y,
                                            const X& x, T c, T zlo, T zhi,
                                            T ylo, T yhi, T xlo, T xhi) {
    T acc = term(x, y.w * z.w, c, xlo, xhi);
    acc = acc + term(y, x.w * z.w, c, ylo, yhi);
    acc = acc + term(z, x.w * y.w, c, zlo, zhi);
    return acc;
  }
};

// One thread per cell: the first 2D design, and the first 3D design.
template <typename T>
int launch_cells(const T* phi, T* out, const T* cx, const T* wx, const T* cy,
                 const T* wy, const T* cz, const T* wz, long long nz,
                 long long ny, long long nx, int dim, cudaStream_t stream) {
  const long long ncell = nz * ny * nx;
  if (ncell <= 0) return 0;
  const int threads = 256;
  long long blocks = (ncell + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride loop covers the rest
  if (dim == 2) {
    poisson_apply_separable_kernel<T, 2><<<(unsigned)blocks, threads, 0, stream>>>(
        phi, out, cx, wx, cy, wy, cz, wz, 1, ny, nx);
  } else if (dim == 3) {
    poisson_apply_separable_kernel<T, 3><<<(unsigned)blocks, threads, 0, stream>>>(
        phi, out, cx, wx, cy, wy, cz, wz, nz, ny, nx);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Row r (-1 <= r <= ny) of the VX columns from i: 0 past a wall (r = -1
// or ny) and for a lane past nx.
template <typename T, int VX>
__device__ __forceinline__ void row_at(const T* __restrict__ f, int r, int ny,
                                       int nx, int i, bool active,
                                       T (&v)[VX]) {
  if (active && r >= 0 && r < ny) {
    load_x<T, VX>(f + r * nx + i, v);
  } else {
#pragma unroll
    for (int u = 0; u < VX; ++u) v[u] = T(0);
  }
}

// The 2D row march (the header's "2D design"): a block of TX / VX threads
// owns the band of TX columns from blockIdx.x * TX and the chunk of ky rows
// from blockIdx.y * ky; warp w of it the 32 VX columns from the band's
// 32 VX w, lane l the VX columns from there + VX l.  The march takes RY
// rows at a time (a group), their loads in flight together.  Each cell in
// the twin's order: x first, each product and sum rounded on its own.
template <typename T, int TX, int RY, int VX>
__global__ void __launch_bounds__(TX / VX)
rowmarch(const T* __restrict__ f, T* __restrict__ out,
         const T* __restrict__ cx, const T* __restrict__ wx,
         const T* __restrict__ cy, const T* __restrict__ wy, int ny, int nx,
         int ky) {
  constexpr int kLanes = 32;
  constexpr int kBand = kLanes * VX;  // a warp's columns
  static_assert(TX % kBand == 0, "a band of whole warps");
  const int lane = threadIdx.x & (kLanes - 1);
  // the warp's first column; a warp past the field has nothing to do
  // (uniform across the warp, and no block barrier follows)
  const int i0 = blockIdx.x * TX + (threadIdx.x - lane) * VX;
  if (i0 >= nx) return;
  const int i = i0 + lane * VX;  // the thread's first column
  // with VX > 1 the C entry takes only nx a multiple of VX, so a thread's
  // columns are all in the array or all past it
  const bool active = i < nx;
  const int j0 = blockIdx.y * ky;
  const int j1 = min(j0 + ky, ny);  // rows j0 .. j1-1; row j1 is read too
  // the halo column of lane 0 (left of the band) and of lane 31 (right of
  // it), read where it is in the array; every other lane reads none
  const int ih = lane == 0 ? i0 - 1 : i0 + kBand;
  const bool hread =
      (lane == 0 || lane == kLanes - 1) && ih >= 0 && ih < nx;

  // the thread's columns' x factors: c[i], c[i+1], their sum, w[i]
  T xlo[VX], xhi[VX], xsum[VX], xw[VX];
#pragma unroll
  for (int u = 0; u < VX; ++u) {
    xlo[u] = active ? ldg(cx + i + u) : T(0);
    xhi[u] = active ? ldg(cx + i + u + 1) : T(0);
    xsum[u] = xlo[u] + xhi[u];
    xw[u] = active ? ldg(wx + i + u) : T(0);
  }
  // When the group from row g starts, q[a] holds row g-1+a of the
  // thread's columns (a <= RY+1), halo[r] row g+r's halo cell, ycv[r]
  // cy[g+r] (r <= RY) and ywv[r] wy[g+r]; q[RY+2+b] takes row g+RY+1+b
  // and the *_next arrays the next group's halo cells and y factors,
  // loaded during group g.  So the first group waits for one round of
  // loads and every later one for none it did not ask for a group
  // earlier.  What lies past the chunk (a row past j1, a factor no row of
  // it reads) is 0 and not read.
  T q[2 * RY + 2][VX];
  T halo[RY], ycv[RY + 1], ywv[RY];
#pragma unroll
  for (int a = 0; a < RY + 2; ++a)
    row_at<T, VX>(f, j0 - 1 + a <= j1 ? j0 - 1 + a : -1, ny, nx, i, active,
                  q[a]);
#pragma unroll
  for (int r = 0; r < RY; ++r) {
    halo[r] = hread && j0 + r < j1 ? f[(j0 + r) * nx + ih] : T(0);
    ywv[r] = j0 + r < j1 ? ldg(wy + j0 + r) : T(0);
  }
#pragma unroll
  for (int r = 0; r <= RY; ++r) ycv[r] = j0 + r <= j1 ? ldg(cy + j0 + r) : T(0);

  for (int g = j0; g < j1; g += RY) {
    // the loads ahead: rows g+RY+1 .. g+2RY (to the chunk's upper halo
    // row j1), and the next group's halo cells and y factors
    const int gn = g + RY;
    T halo_next[RY], ycv_next[RY], ywv_next[RY];
#pragma unroll
    for (int b = 0; b < RY; ++b) {
      row_at<T, VX>(f, gn + 1 + b <= j1 ? gn + 1 + b : -1, ny, nx, i, active,
                    q[RY + 2 + b]);
      halo_next[b] = hread && gn + b < j1 ? f[(gn + b) * nx + ih] : T(0);
      ywv_next[b] = gn + b < j1 ? ldg(wy + gn + b) : T(0);
      ycv_next[b] = gn + 1 + b <= j1 ? ldg(cy + gn + 1 + b) : T(0);
    }

#pragma unroll
    for (int r = 0; r < RY; ++r) {
      const int j = g + r;
      if (j >= j1) break;  // a ragged last group (uniform across the block)
      const T* c = q[r + 1];
      const T ylo = ycv[r], yhi = ycv[r + 1], yw = ywv[r];
      const T ysum = ylo + yhi;
      // the x neighbours of the thread's first and last column
      T left = shfl(c[VX - 1], lane - 1);
      T right = shfl(c[0], lane + 1);
      if (lane == 0) left = halo[r];
      if (lane == kLanes - 1) right = halo[r];
      T acc[VX];
#pragma unroll
      for (int u = 0; u < VX; ++u) {
        const T p = c[u];
        const T xl = u == 0 ? left : c[u > 0 ? u - 1 : 0];
        const T xr = u == VX - 1 ? right : c[u < VX - 1 ? u + 1 : 0];
        acc[u] = yw * ((xsum[u] * p - xlo[u] * xl) - xhi[u] * xr);
        acc[u] =
            acc[u] + xw[u] * ((ysum * p - ylo * q[r][u]) - yhi * q[r + 2][u]);
      }
      if (active) store_x<T, VX>(out + j * nx + i, acc);
    }
#pragma unroll
    for (int a = 0; a < RY + 2; ++a)
#pragma unroll
      for (int u = 0; u < VX; ++u) q[a][u] = q[a + RY][u];
    ycv[0] = ycv[RY];
#pragma unroll
    for (int r = 0; r < RY; ++r) {
      halo[r] = halo_next[r];
      ywv[r] = ywv_next[r];
      ycv[r + 1] = ycv_next[r];
    }
  }
}

// the row tiles (TX, RY, VX) the plan may ask for (operators/cuda_stencil.py
// ROW_TILES, as (TX, 1, RY, VX)): four warps of two columns, or of one
#define ROW_TILES(X) X(256, 1, 2) X(128, 1, 1)

// 2D: checks the shape and the plan (the tile (tx, ty, ry, vx) = (TX, 1,
// RY, VX) and kz rows a chunk, from operators/cuda_stencil.py row_plan)
// and launches the row march; the field is checked as a z march of ny
// planes of one row.
template <typename T>
int launch_rows(const T* phi, T* out, const T* cx, const T* wx, const T* cy,
                const T* wy, long long nz, long long ny, long long nx, int tx,
                int ty, int ry, int vx, int kz, cudaStream_t stream) {
  if (nz != 1) return (int)cudaErrorInvalidValue;
  const int checked = check_march(phi, out, ny, 1, nx, vx, kz);
  if (checked != 0) return checked < 0 ? 0 : checked;
  if (ty != 1) return (int)cudaErrorInvalidValue;
#define ROW_LAUNCH(TX, RY, VX)                                               \
  if (tx == TX && ry == RY && vx == VX) {                                    \
    const dim3 grid((unsigned)((nx + TX - 1) / TX),                          \
                    (unsigned)((ny + kz - 1) / kz));                         \
    rowmarch<T, TX, RY, VX><<<grid, TX / VX, 0, stream>>>(                   \
        phi, out, cx, wx, cy, wy, (int)ny, (int)nx, kz);                     \
    return (int)cudaGetLastError();                                          \
  }
  ROW_TILES(ROW_LAUNCH)
#undef ROW_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// 2D: the row march; 3D: the z march.  Each checks the shape and the plan
// (tx, ty, ry, vx, kz from operators/cuda_stencil.py separable_plan_on_card);
// the refusals are mirrored by cuda_stencil.plan_error, but for the
// pointers' alignment.
template <typename T>
int launch(const T* phi, T* out, const T* cx, const T* wx, const T* cy,
           const T* wy, const T* cz, const T* wz, long long nz, long long ny,
           long long nx, int dim, int tx, int ty, int ry, int vx, int kz,
           cudaStream_t stream) {
  if (dim == 2)
    return launch_rows(phi, out, cx, wx, cy, wy, nz, ny, nx, tx, ty, ry, vx,
                       kz, stream);
  if (dim != 3) return (int)cudaErrorInvalidValue;
  const int checked = check_march(phi, out, nz, ny, nx, vx, kz);
  if (checked != 0) return checked < 0 ? 0 : checked;
  const MarchShape a{nz, ny, nx, false, false, false};
  return launch_tile<T, SeparableBody<T>>(phi, out, {cx, wx, cy, wy, cz, wz},
                                          a, tx, ty, ry, vx, kz, stream);
}

// The blocks of the tile's instance the current device holds at once, into
// *slots (0 on success): a row tile (TX, 1, RY, VX) of the row march, else
// a z-march tile (march.cuh resident).
template <typename T>
int separable_resident(int tx, int ty, int ry, int vx, int* slots) {
  if (ty != 1) return resident<T, SeparableBody<T>>(tx, ty, ry, vx, slots);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
#define ROW_RESIDENT(TX, RY, VX)                               \
  if (tx == TX && ry == RY && vx == VX)                        \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(       \
        &per_sm, rowmarch<T, TX, RY, VX>, TX / VX, 0);         \
  else
  ROW_TILES(ROW_RESIDENT) return (int)cudaErrorInvalidValue;
#undef ROW_RESIDENT
  *slots = sms * per_sm;
  return (int)err;
}

}  // namespace

// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, 0 on success, cudaErrorInvalidValue for a shape or plan the
// kernel does not take.  For dim == 2, nz must be 1, cz/wz may be null and
// the plan is a row tile (tx, 1, ry, vx) with kz rows a chunk.
extern "C" int poisson_apply_separable_f32(
    const float* phi, float* out, const float* cx, const float* wx,
    const float* cy, const float* wy, const float* cz, const float* wz,
    long long nz, long long ny, long long nx, int dim, int tx, int ty, int ry,
    int vx, int kz, void* stream) {
  return launch<float>(phi, out, cx, wx, cy, wy, cz, wz, nz, ny, nx, dim, tx,
                       ty, ry, vx, kz, (cudaStream_t)stream);
}

extern "C" int poisson_apply_separable_f64(
    const double* phi, double* out, const double* cx, const double* wx,
    const double* cy, const double* wy, const double* cz, const double* wz,
    long long nz, long long ny, long long nx, int dim, int tx, int ty, int ry,
    int vx, int kz, void* stream) {
  return launch<double>(phi, out, cx, wx, cy, wy, cz, wz, nz, ny, nx, dim, tx,
                        ty, ry, vx, kz, (cudaStream_t)stream);
}

extern "C" int poisson_apply_separable_bf16(
    const unsigned short* phi, unsigned short* out, const unsigned short* cx,
    const unsigned short* wx, const unsigned short* cy,
    const unsigned short* wy, const unsigned short* cz,
    const unsigned short* wz, long long nz, long long ny, long long nx,
    int dim, int tx, int ty, int ry, int vx, int kz, void* stream) {
  return launch<bf16>(as_bf16(phi), as_bf16(out), as_bf16(cx), as_bf16(wx),
                      as_bf16(cy), as_bf16(wy), as_bf16(cz), as_bf16(wz), nz,
                      ny, nx, dim, tx, ty, ry, vx, kz, (cudaStream_t)stream);
}

extern "C" int poisson_apply_separable_resident_f32(int tx, int ty, int ry,
                                                    int vx, int* slots) {
  return separable_resident<float>(tx, ty, ry, vx, slots);
}

extern "C" int poisson_apply_separable_resident_f64(int tx, int ty, int ry,
                                                    int vx, int* slots) {
  return separable_resident<double>(tx, ty, ry, vx, slots);
}

extern "C" int poisson_apply_separable_resident_bf16(int tx, int ty, int ry,
                                                     int vx, int* slots) {
  return separable_resident<bf16>(tx, ty, ry, vx, slots);
}

// One thread per cell in 2D or 3D (the first designs of both): the
// arguments of the entries above without the plan.
extern "C" int poisson_apply_separable_cells_f32(
    const float* phi, float* out, const float* cx, const float* wx,
    const float* cy, const float* wy, const float* cz, const float* wz,
    long long nz, long long ny, long long nx, int dim, void* stream) {
  return launch_cells<float>(phi, out, cx, wx, cy, wy, cz, wz, nz, ny, nx,
                             dim, (cudaStream_t)stream);
}

extern "C" int poisson_apply_separable_cells_f64(
    const double* phi, double* out, const double* cx, const double* wx,
    const double* cy, const double* wy, const double* cz, const double* wz,
    long long nz, long long ny, long long nx, int dim, void* stream) {
  return launch_cells<double>(phi, out, cx, wx, cy, wy, cz, wz, nz, ny, nx,
                              dim, (cudaStream_t)stream);
}

extern "C" int poisson_apply_separable_cells_bf16(
    const unsigned short* phi, unsigned short* out, const unsigned short* cx,
    const unsigned short* wx, const unsigned short* cy,
    const unsigned short* wy, const unsigned short* cz,
    const unsigned short* wz, long long nz, long long ny, long long nx,
    int dim, void* stream) {
  return launch_cells<bf16>(as_bf16(phi), as_bf16(out), as_bf16(cx),
                            as_bf16(wx), as_bf16(cy), as_bf16(wy),
                            as_bf16(cz), as_bf16(wz), nz, ny, nx, dim,
                            (cudaStream_t)stream);
}
