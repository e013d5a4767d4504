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
// 2D design: one thread per cell in a grid-stride loop (DIM == 2 below):
// at 450^2 (810 KB) an apply is close to a launch's floor.  The first 3D
// design, the same loop with DIM == 3, stays behind the second C entry
// poisson_apply_separable_cells_*; only chip_smoke.py and
// scripts/bench_torch_stencil.py call it, to time it beside the march.
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

// One thread per cell: the 2D path, and the first 3D design.
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

// 2D: the cell kernel (the plan is not read).  3D: checks the shape and
// the plan (tx, ty, ry, vx, kz from operators/cuda_stencil.py
// launch_plan) and launches the march; the refusals are mirrored by
// cuda_stencil.plan_error, but for the pointers' alignment.
template <typename T>
int launch(const T* phi, T* out, const T* cx, const T* wx, const T* cy,
           const T* wy, const T* cz, const T* wz, long long nz, long long ny,
           long long nx, int dim, int tx, int ty, int ry, int vx, int kz,
           cudaStream_t stream) {
  if (dim != 3)
    return launch_cells(phi, out, cx, wx, cy, wy, cz, wz, nz, ny, nx, dim,
                        stream);
  const int checked = check_march(phi, out, nz, ny, nx, vx, kz);
  if (checked != 0) return checked < 0 ? 0 : checked;
  const MarchShape a{nz, ny, nx, false, false, false};
  return launch_tile<T, SeparableBody<T>>(phi, out, {cx, wx, cy, wy, cz, wz},
                                          a, tx, ty, ry, vx, kz, stream);
}

}  // namespace

// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, 0 on success, cudaErrorInvalidValue for a shape or plan the
// kernel does not take.  For dim == 2, nz must be 1, cz/wz may be null and
// the plan is not read.
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
  return resident<float, SeparableBody<float>>(tx, ty, ry, vx, slots);
}

extern "C" int poisson_apply_separable_resident_f64(int tx, int ty, int ry,
                                                    int vx, int* slots) {
  return resident<double, SeparableBody<double>>(tx, ty, ry, vx, slots);
}

extern "C" int poisson_apply_separable_resident_bf16(int tx, int ty, int ry,
                                                     int vx, int* slots) {
  return resident<bf16, SeparableBody<bf16>>(tx, ty, ry, vx, slots);
}

// One thread per cell in 2D or 3D (the first 3D design): the arguments of
// the entries above without the plan.
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
