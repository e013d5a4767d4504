// 3D 7-point apply with per-axis 1D coefficients (kernel K2 of the port).
//
// Replaces petibm_tpu/operators/pallas_stencil.py:make_zblocked_helmholtz
// (kernel body _hh_kernel), which serves two callers:
//   K2a  make_pallas_momentum: A u = u/dt - c_imp*nu*L u per velocity
//        component, wall a0 folded into D, CN[0] = CP[n-1] = 0 at walls;
//   K2b  make_pallas_poisson_zblocked: the conservative 3D Poisson apply,
//        periodic wrap coefficients in CN[0] / CP[n-1], with the rank-1
//        scale Sz[k]*Sy[j]*Sx[i] applied after the sum.
// For a (nz, ny, nx) field f (x fastest):
//
//   out = f*(Dz[k] + Dy[j] + Dx[i])
//       + CNz[k]*f[k-1] + CPz[k]*f[k+1] + CNy[j]*f[j-1] + CPy[j]*f[j+1]
//       + CNx[i]*f[i-1] + CPx[i]*f[i+1]          (then * Sz*Sy*Sx if scaled)
//
// in the same order of operations as the Pallas kernel and the plain twin
// (operators/cuda_stencil.py:zblocked_helmholtz_apply_ref).  On a periodic
// axis the neighbour index wraps; past a non-periodic wall the neighbour is
// a literal 0 and is never read (the Pallas kernel zeroes its padded rows
// for the same reason: 0 * NaN would poison the sum).
//
// Bound: device-memory bandwidth.  The mandatory traffic is read f and
// write out: 8 B/cell in float32, 21.6 MB for the 2.70 M cells of the
// sphere's velocity components, 6.5 us at 3.35 TB/s.  The nine (or twelve)
// 1D vectors are a few KB and stay in cache.  Design: one thread per cell,
// x fastest, so a warp reads 32 consecutive values; the x neighbours come
// from the same lines in L1, the y and z neighbours (one row and one plane
// away) from L1/L2, which holds several planes of even a 256^3 field.  The
// Pallas kernel's z-blocks, halo planes and block sizing only fit TPU VMEM
// and are not carried over.

#include <cuda_runtime.h>

namespace {

template <typename T>
struct Coeffs {
  const T* d;   // diagonal part of the axis
  const T* cn;  // lower-neighbour coefficient
  const T* cp;  // upper-neighbour coefficient
};

template <typename T, bool SCALED>
__global__ void zblocked_helmholtz_kernel(
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

template <typename T>
int launch(const T* f, T* out, const T* dz, const T* cnz, const T* cpz,
           const T* dy, const T* cny, const T* cpy, const T* dx,
           const T* cnx, const T* cpx, const T* sz, const T* sy, const T* sx,
           long long nz, long long ny, long long nx, int pz, int py, int px,
           cudaStream_t stream) {
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
    zblocked_helmholtz_kernel<T, true><<<(unsigned)blocks, threads, 0, stream>>>(
        f, out, z, y, x, sz, sy, sx, (int)nz, (int)ny, (int)nx, pz != 0,
        py != 0, px != 0);
  } else {
    zblocked_helmholtz_kernel<T, false><<<(unsigned)blocks, threads, 0, stream>>>(
        f, out, z, y, x, sz, sy, sx, (int)nz, (int)ny, (int)nx, pz != 0,
        py != 0, px != 0);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, 0 on success.  sz, sy and sx are all null (no scale) or all set.
extern "C" int zblocked_helmholtz_f32(
    const float* f, float* out, const float* dz, const float* cnz,
    const float* cpz, const float* dy, const float* cny, const float* cpy,
    const float* dx, const float* cnx, const float* cpx, const float* sz,
    const float* sy, const float* sx, long long nz, long long ny,
    long long nx, int pz, int py, int px, void* stream) {
  return launch<float>(f, out, dz, cnz, cpz, dy, cny, cpy, dx, cnx, cpx, sz,
                       sy, sx, nz, ny, nx, pz, py, px, (cudaStream_t)stream);
}

extern "C" int zblocked_helmholtz_f64(
    const double* f, double* out, const double* dz, const double* cnz,
    const double* cpz, const double* dy, const double* cny, const double* cpy,
    const double* dx, const double* cnx, const double* cpx, const double* sz,
    const double* sy, const double* sx, long long nz, long long ny,
    long long nx, int pz, int py, int px, void* stream) {
  return launch<double>(f, out, dz, cnz, cpz, dy, cny, cpy, dx, cnx, cpx, sz,
                        sy, sx, nz, ny, nx, pz, py, px, (cudaStream_t)stream);
}
