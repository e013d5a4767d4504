// 3D 7-point apply with per-axis 1D coefficients (kernel K2 of the port).
//
// Replaces petibm_tpu/operators/pallas_stencil.py:236 make_zblocked_helmholtz
// (kernel body _hh_kernel), which serves two callers:
//   K2a  make_pallas_momentum (:318): A u = u/dt - c_imp*nu*L u per
//        velocity component, wall a0 folded into D, CN[0] = CP[n-1] = 0 at
//        walls;
//   K2b  make_pallas_poisson_zblocked (:388): the conservative 3D Poisson
//        apply, periodic wrap coefficients in CN[0] / CP[n-1], with the
//        rank-1 scale Sz[k]*Sy[j]*Sx[i] applied after the sum.
// For a (nz, ny, nx) field f (x fastest):
//
//   out = f*((Dz[k] + Dy[j]) + Dx[i])
//       + CNz[k]*f[k-1] + CPz[k]*f[k+1] + CNy[j]*f[j-1] + CPy[j]*f[j+1]
//       + CNx[i]*f[i-1] + CPx[i]*f[i+1]     (then * ((Sz*Sy)*Sx) if scaled)
//
// summed from left to right, each product and sum rounded on its own: the
// order of the Pallas kernel and of the plain twin
// (operators/cuda_stencil.py:zblocked_helmholtz_apply_ref).  The source is
// built with --fmad=false (_kernels.EXTRA_FLAGS), so no multiply-add is
// contracted into an FMA and the result equals the twin's bit for bit.  On
// a periodic axis the neighbour wraps; past a non-periodic wall the
// neighbour is a literal 0 and is never read (the Pallas kernel zeroes its
// padded rows for the same reason: 0 * NaN would poison the sum).
//
// Bound: device-memory bandwidth.  The work that must be done is to read f
// once and write out once: 8 B a cell in float32, 134 MB at 256^3, 40.1 us
// at 3.35 TB/s (80.1 us in float64); the 15 to 18 operations a cell take
// 3.8 us at 67 TFLOP/s.  The coefficient vectors are a few KB.
//
// Design: the z march of march.cuh (2.5D blocking: a block marches a
// TX x TY tile of the xy plane up a chunk of planes in z, each column's z
// neighbours in registers, the x and y neighbours from a double-buffered
// shared tile with a one-cell halo), with HelmholtzBody below as the cell:
// - A thread holds its own Dx, CNx, CPx, Dy, CNy, CPy (and Sy, Sx) for the
//   whole march; Dz, CNz, CPz (and Sz) are one uniform load a plane.
// - What bound it, as measured (scripts/bench_torch_stencil.py): the loads
//   a thread has in flight and the share of the card's blocks that run at
//   once.  One cell a thread took 68 us at 256^3 in float32; RY rows and
//   VX columns a thread put 2 to 4 loads in flight, and the plan cuts z
//   into as many chunks as fill exactly one wave of the blocks the card
//   holds at once (resident in march.cuh): a grid a fraction past one wave
//   ran 20-30% slower.  A ring of planes filled by cp.async lost to the
//   registers; the halo loads and FMA contraction cost under 2% at 256^3.
//
// Measured on an H100 80GB HBM3 at 700 W, median device time an apply
// (chip_smoke.py phase 2): see PERF.md section 6, K2a and K2b rows.
//
// The first design, one thread per cell in a grid-stride loop with the
// wrap decided per neighbour (zblocked_helmholtz_cells), stays behind the
// second C entry zblocked_helmholtz_cells_*; only chip_smoke.py and
// scripts/bench_torch_stencil.py call it, to time it beside the march.

#include <cuda_runtime.h>

#include "march.cuh"

namespace {

template <typename T>
struct Coeffs {
  const T* d;   // diagonal part of the axis
  const T* cn;  // lower-neighbour coefficient
  const T* cp;  // upper-neighbour coefficient
};

// The cell of K2 in the march: the twin's sum, left to right, then the
// scale when SCALED.
template <typename T, bool SCALED>
struct HelmholtzBody {
  struct Params {
    Coeffs<T> z, y, x;
    const T* sz;
    const T* sy;
    const T* sx;
  };
  // an axis's coefficients at one index: D, CN, CP and the scale
  struct Axis {
    T d, cn, cp, s;
  };
  using X = Axis;
  using Y = Axis;
  using Z = Axis;

  static __device__ __forceinline__ Axis at(const Coeffs<T>& c,
                                            const T* s, int n) {
    return {__ldg(c.d + n), __ldg(c.cn + n), __ldg(c.cp + n),
            SCALED ? __ldg(s + n) : T(0)};
  }
  static __device__ __forceinline__ X x_at(const Params& p, int i) {
    return at(p.x, p.sx, i);
  }
  static __device__ __forceinline__ Y y_at(const Params& p, int j) {
    return at(p.y, p.sy, j);
  }
  static __device__ __forceinline__ Z z_at(const Params& p, int k) {
    return at(p.z, p.sz, k);
  }
  static __device__ __forceinline__ T apply(const Z& z, const Y& y,
                                            const X& x, T c, T zlo, T zhi,
                                            T ylo, T yhi, T xlo, T xhi) {
    T acc = c * ((z.d + y.d) + x.d);
    acc = acc + z.cn * zlo;
    acc = acc + z.cp * zhi;
    acc = acc + y.cn * ylo;
    acc = acc + y.cp * yhi;
    acc = acc + x.cn * xlo;
    acc = acc + x.cp * xhi;
    if (SCALED) acc = acc * ((z.s * y.s) * x.s);
    return acc;
  }
};

template <typename T, bool SCALED>
__global__ void zblocked_helmholtz_cells(
    const T* __restrict__ f, T* __restrict__ out, Coeffs<T> z, Coeffs<T> y,
    Coeffs<T> x, const T* __restrict__ sz, const T* __restrict__ sy,
    const T* __restrict__ sx, int nz, int ny, int nx, bool pz, bool py,
    bool px) {
  const int plane = ny * nx;
  const int ncell = nz * plane;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < ncell;
       idx += gridDim.x * blockDim.x) {
    const int i = idx % nx;
    const int t = idx / nx;
    const int j = t % ny;
    const int k = t / ny;
    const T c = f[idx];

    const T lo_z = k > 0 ? f[idx - plane]
                         : (pz ? f[idx + (nz - 1) * plane] : T(0));
    const T hi_z = k < nz - 1 ? f[idx + plane]
                              : (pz ? f[idx - (nz - 1) * plane] : T(0));
    const T lo_y = j > 0 ? f[idx - nx] : (py ? f[idx + (ny - 1) * nx] : T(0));
    const T hi_y = j < ny - 1 ? f[idx + nx]
                              : (py ? f[idx - (ny - 1) * nx] : T(0));
    const T lo_x = i > 0 ? f[idx - 1] : (px ? f[idx + (nx - 1)] : T(0));
    const T hi_x = i < nx - 1 ? f[idx + 1] : (px ? f[idx - (nx - 1)] : T(0));

    T acc = c * (z.d[k] + y.d[j] + x.d[i]);
    acc = acc + z.cn[k] * lo_z;
    acc = acc + z.cp[k] * hi_z;
    acc = acc + y.cn[j] * lo_y;
    acc = acc + y.cp[j] * hi_y;
    acc = acc + x.cn[i] * lo_x;
    acc = acc + x.cp[i] * hi_x;
    if (SCALED) acc = acc * (sz[k] * sy[j] * sx[i]);
    out[idx] = acc;
  }
}

// Checks the shape and the plan (tx, ty, ry, vx, kz from
// operators/cuda_stencil.py launch_plan) and launches the march; the
// refusals are mirrored by cuda_stencil.plan_error, but for the pointers'
// alignment.
template <typename T>
int launch(const T* f, T* out, const T* dz, const T* cnz, const T* cpz,
           const T* dy, const T* cny, const T* cpy, const T* dx,
           const T* cnx, const T* cpx, const T* sz, const T* sy, const T* sx,
           long long nz, long long ny, long long nx, int pz, int py, int px,
           int tx, int ty, int ry, int vx, int kz, cudaStream_t stream) {
  const int checked = check_march(f, out, nz, ny, nx, vx, kz);
  if (checked != 0) return checked < 0 ? 0 : checked;
  const bool scaled = sz != nullptr;
  if (scaled != (sy != nullptr) || scaled != (sx != nullptr))
    return (int)cudaErrorInvalidValue;
  const Coeffs<T> z{dz, cnz, cpz}, y{dy, cny, cpy}, x{dx, cnx, cpx};
  const MarchShape a{nz, ny, nx, pz != 0, py != 0, px != 0};
  if (scaled)
    return launch_tile<T, HelmholtzBody<T, true>>(
        f, out, {z, y, x, sz, sy, sx}, a, tx, ty, ry, vx, kz, stream);
  return launch_tile<T, HelmholtzBody<T, false>>(
      f, out, {z, y, x, sz, sy, sx}, a, tx, ty, ry, vx, kz, stream);
}

template <typename T>
int launch_cells(const T* f, T* out, const T* dz, const T* cnz, const T* cpz,
                 const T* dy, const T* cny, const T* cpy, const T* dx,
                 const T* cnx, const T* cpx, const T* sz, const T* sy,
                 const T* sx, long long nz, long long ny, long long nx, int pz,
                 int py, int px, cudaStream_t stream) {
  const long long ncell = nz * ny * nx;
  if (ncell <= 0) return 0;
  if (ncell >= (1LL << 31)) return (int)cudaErrorInvalidValue;  // int indices
  const int threads = 256;
  long long blocks = (ncell + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride loop covers the rest
  const Coeffs<T> z{dz, cnz, cpz}, y{dy, cny, cpy}, x{dx, cnx, cpx};
  const bool scaled = sz != nullptr;
  if (scaled != (sy != nullptr) || scaled != (sx != nullptr))
    return (int)cudaErrorInvalidValue;
  if (scaled) {
    zblocked_helmholtz_cells<T, true><<<(unsigned)blocks, threads, 0, stream>>>(
        f, out, z, y, x, sz, sy, sx, (int)nz, (int)ny, (int)nx, pz != 0,
        py != 0, px != 0);
  } else {
    zblocked_helmholtz_cells<T, false><<<(unsigned)blocks, threads, 0, stream>>>(
        f, out, z, y, x, sz, sy, sx, (int)nz, (int)ny, (int)nx, pz != 0,
        py != 0, px != 0);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, 0 on success, cudaErrorInvalidValue for a shape or plan the
// kernel does not take.  sz, sy and sx are all null (no scale) or all set.
extern "C" int zblocked_helmholtz_f32(
    const float* f, float* out, const float* dz, const float* cnz,
    const float* cpz, const float* dy, const float* cny, const float* cpy,
    const float* dx, const float* cnx, const float* cpx, const float* sz,
    const float* sy, const float* sx, long long nz, long long ny,
    long long nx, int pz, int py, int px, int tx, int ty, int ry, int vx,
    int kz, void* stream) {
  return launch<float>(f, out, dz, cnz, cpz, dy, cny, cpy, dx, cnx, cpx, sz,
                       sy, sx, nz, ny, nx, pz, py, px, tx, ty, ry, vx, kz,
                       (cudaStream_t)stream);
}

extern "C" int zblocked_helmholtz_f64(
    const double* f, double* out, const double* dz, const double* cnz,
    const double* cpz, const double* dy, const double* cny, const double* cpy,
    const double* dx, const double* cnx, const double* cpx, const double* sz,
    const double* sy, const double* sx, long long nz, long long ny,
    long long nx, int pz, int py, int px, int tx, int ty, int ry, int vx,
    int kz, void* stream) {
  return launch<double>(f, out, dz, cnz, cpz, dy, cny, cpy, dx, cnx, cpx, sz,
                        sy, sx, nz, ny, nx, pz, py, px, tx, ty, ry, vx, kz,
                        (cudaStream_t)stream);
}

extern "C" int zblocked_helmholtz_resident_f32(int scaled, int tx, int ty,
                                               int ry, int vx, int* slots) {
  return scaled ? resident<float, HelmholtzBody<float, true>>(tx, ty, ry, vx,
                                                             slots)
                : resident<float, HelmholtzBody<float, false>>(tx, ty, ry,
                                                              vx, slots);
}

extern "C" int zblocked_helmholtz_resident_f64(int scaled, int tx, int ty,
                                               int ry, int vx, int* slots) {
  return scaled ? resident<double, HelmholtzBody<double, true>>(tx, ty, ry,
                                                               vx, slots)
                : resident<double, HelmholtzBody<double, false>>(tx, ty, ry,
                                                                vx, slots);
}

// The first design, one thread per cell: the arguments of the entries
// above without the plan.
extern "C" int zblocked_helmholtz_cells_f32(
    const float* f, float* out, const float* dz, const float* cnz,
    const float* cpz, const float* dy, const float* cny, const float* cpy,
    const float* dx, const float* cnx, const float* cpx, const float* sz,
    const float* sy, const float* sx, long long nz, long long ny,
    long long nx, int pz, int py, int px, void* stream) {
  return launch_cells<float>(f, out, dz, cnz, cpz, dy, cny, cpy, dx, cnx, cpx,
                             sz, sy, sx, nz, ny, nx, pz, py, px,
                             (cudaStream_t)stream);
}

extern "C" int zblocked_helmholtz_cells_f64(
    const double* f, double* out, const double* dz, const double* cnz,
    const double* cpz, const double* dy, const double* cny, const double* cpy,
    const double* dx, const double* cnx, const double* cpx, const double* sz,
    const double* sy, const double* sx, long long nz, long long ny,
    long long nx, int pz, int py, int px, void* stream) {
  return launch_cells<double>(f, out, dz, cnz, cpz, dy, cny, cpy, dx, cnx,
                              cpx, sz, sy, sx, nz, ny, nx, pz, py, px,
                              (cudaStream_t)stream);
}
