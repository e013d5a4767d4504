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
// c_hi_d = c_d[i+1], area_d = prod_{e != d} w_e.  Neighbours outside the
// array contribute 0 (at non-periodic walls c_d is 0 there anyway).
//
// Bound: device-memory bandwidth.  The mandatory traffic is read phi and
// write out, 8 B/cell in float32 (1.6 MB at 450^2, 3.2 MB in float64); the
// 1D factors are a few KB and stay in cache.  Design: one thread per cell, x fastest, so a
// warp reads 32 consecutive phi values; the neighbour reads of adjacent
// threads and rows are served by L1/L2 instead of shared-memory tiles.
// Shared-memory tiling is left for a later change.

#include <cuda_runtime.h>

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

template <typename T>
int launch(const T* phi, T* out, const T* cx, const T* wx, const T* cy,
           const T* wy, const T* cz, const T* wz, long long nz, long long ny,
           long long nx, int dim, cudaStream_t stream) {
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

}  // namespace

// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, 0 on success.  For dim == 2, nz must be 1 and cz/wz may be null.
extern "C" int poisson_apply_separable_f32(
    const float* phi, float* out, const float* cx, const float* wx,
    const float* cy, const float* wy, const float* cz, const float* wz,
    long long nz, long long ny, long long nx, int dim, void* stream) {
  return launch<float>(phi, out, cx, wx, cy, wy, cz, wz, nz, ny, nx, dim,
                       (cudaStream_t)stream);
}

extern "C" int poisson_apply_separable_f64(
    const double* phi, double* out, const double* cx, const double* wx,
    const double* cy, const double* wy, const double* cz, const double* wz,
    long long nz, long long ny, long long nx, int dim, void* stream) {
  return launch<double>(phi, out, cx, wx, cy, wy, cz, wz, nz, ny, nx, dim,
                        (cudaStream_t)stream);
}
