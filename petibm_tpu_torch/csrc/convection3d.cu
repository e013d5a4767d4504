// 3D divergence-form convection N(u), one output component per launch
// (kernel K3 of the port).
//
// Replaces petibm_tpu/operators/pallas_stencil.py:make_pallas_convection
// (kernel body _conv_kernel).  For velocity component c with output shape
// (nz, ny, nx) it reads the three ghost-extended velocity arrays ext[e]
// (shape of component e plus 2 on every axis, filled by
// BoundarySet.extend) and forms, for each direction d (array axis 2-d),
// from 2-point face averages
//
//   d == c:  (fE^2 - fW^2) * inv_dl_d          fW = (u[-1] + u) / 2 ...
//   d != c:  (advP*aP - advM*aM) * inv_dl_d    aM/aP: faces of u_c along d,
//            advM/advP: u_d averaged along c at the two faces along d
//
// and sums the three terms in direction order, as the Pallas kernel and
// the plain twin (operators/cuda_stencil.py:convection3d_apply_ref) do.
// A window W(e, offsets) is ext[e][1 + oz + k, 1 + oy + j, 1 + ox + i]:
// each extended array is read with its own strides through a window shaped
// like component c.
//
// Bound: device-memory bandwidth.  Mandatory traffic per launch: the three
// extended inputs once and the output once, ~16 B/cell in float32 (the
// 15 reads per cell hit the same few rows and planes, served from L1/L2).
// Design: one thread per output cell, x fastest, so warps read consecutive
// addresses of each array; the direction loop and the component are
// compile-time, so every window offset folds into a constant.  The Pallas
// kernel's z-blocks and trailing halo planes only fit TPU VMEM and are not
// carried over.

#include <cuda_runtime.h>

namespace {

template <typename T>
struct Ext {
  const T* p;
  int ey, ex;  // extended y and x extents (row and plane strides)
};

// ext[1 + oz + k, 1 + oy + j, 1 + ox + i]
template <typename T>
__device__ __forceinline__ T win(const Ext<T>& e, int k, int j, int i,
                                 int ox, int oy, int oz) {
  return e.p[((long long)(k + 1 + oz) * e.ey + (j + 1 + oy)) * e.ex +
             (i + 1 + ox)];
}

// offset vector (x, y, z) with a along direction da and b along db
#define OFS(da, a, db, b)                              \
  ((da) == 0 ? (a) : 0) + ((db) == 0 ? (b) : 0),       \
      ((da) == 1 ? (a) : 0) + ((db) == 1 ? (b) : 0),   \
      ((da) == 2 ? (a) : 0) + ((db) == 2 ? (b) : 0)

template <typename T, int C>
__global__ void convection3d_kernel(Ext<T> e0, Ext<T> e1, Ext<T> e2,
                                    T* __restrict__ out,
                                    const T* __restrict__ ivx,
                                    const T* __restrict__ ivy,
                                    const T* __restrict__ ivz, int nz, int ny,
                                    int nx) {
  const Ext<T> ext[3] = {e0, e1, e2};
  const Ext<T>& own = ext[C];
  const int ncell = nz * ny * nx;
  const T half = T(0.5);
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < ncell;
       idx += gridDim.x * blockDim.x) {
    const int i = idx % nx;
    const int t = idx / nx;
    const int j = t % ny;
    const int k = t / ny;
    const T u0 = win(own, k, j, i, 0, 0, 0);
    T total = T(0);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const T iv = d == 0 ? ivx[i] : (d == 1 ? ivy[j] : ivz[k]);
      const T um = win(own, k, j, i, OFS(d, -1, d, 0));
      const T up = win(own, k, j, i, OFS(d, 1, d, 0));
      T term;
      if (d == C) {
        const T fW = half * (um + u0);
        const T fE = half * (u0 + up);
        term = (fE * fE - fW * fW) * iv;
      } else {
        const Ext<T>& adv = ext[d];
        const T aM = half * (um + u0);
        const T aP = half * (u0 + up);
        const T advM = half * (win(adv, k, j, i, OFS(d, -1, C, 0)) +
                               win(adv, k, j, i, OFS(d, -1, C, 1)));
        const T advP = half * (win(adv, k, j, i, OFS(d, 0, C, 0)) +
                               win(adv, k, j, i, OFS(d, 0, C, 1)));
        term = (advP * aP - advM * aM) * iv;
      }
      total = d == 0 ? term : total + term;
    }
    out[idx] = total;
  }
}

#undef OFS

template <typename T>
int launch(const T* e0, const T* e1, const T* e2, const long long* ext_shape,
           T* out, const T* ivx, const T* ivy, const T* ivz, long long nz,
           long long ny, long long nx, int c, cudaStream_t stream) {
  const long long ncell = nz * ny * nx;
  if (ncell <= 0) return 0;
  long long total_ext = 1;
  for (int e = 0; e < 3; ++e) {
    const long long n = ext_shape[3 * e] * ext_shape[3 * e + 1] *
                        ext_shape[3 * e + 2];
    if (n > total_ext) total_ext = n;
  }
  if (total_ext >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const Ext<T> a{e0, (int)ext_shape[1], (int)ext_shape[2]};
  const Ext<T> b{e1, (int)ext_shape[4], (int)ext_shape[5]};
  const Ext<T> d{e2, (int)ext_shape[7], (int)ext_shape[8]};
  const int threads = 256;
  long long blocks = (ncell + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride loop covers the rest
  const unsigned grid = (unsigned)blocks;
  switch (c) {
    case 0:
      convection3d_kernel<T, 0><<<grid, threads, 0, stream>>>(
          a, b, d, out, ivx, ivy, ivz, (int)nz, (int)ny, (int)nx);
      break;
    case 1:
      convection3d_kernel<T, 1><<<grid, threads, 0, stream>>>(
          a, b, d, out, ivx, ivy, ivz, (int)nz, (int)ny, (int)nx);
      break;
    case 2:
      convection3d_kernel<T, 2><<<grid, threads, 0, stream>>>(
          a, b, d, out, ivx, ivy, ivz, (int)nz, (int)ny, (int)nx);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, 0 on success.  ext_shape is a host array of 9 extents, (z, y, x)
// of ext0, ext1 and ext2; (nz, ny, nx) is the output shape of component c.
extern "C" int convection3d_f32(const float* e0, const float* e1,
                                const float* e2, const long long* ext_shape,
                                float* out, const float* ivx,
                                const float* ivy, const float* ivz,
                                long long nz, long long ny, long long nx,
                                int c, void* stream) {
  return launch<float>(e0, e1, e2, ext_shape, out, ivx, ivy, ivz, nz, ny, nx,
                       c, (cudaStream_t)stream);
}

extern "C" int convection3d_f64(const double* e0, const double* e1,
                                const double* e2, const long long* ext_shape,
                                double* out, const double* ivx,
                                const double* ivy, const double* ivz,
                                long long nz, long long ny, long long nx,
                                int c, void* stream) {
  return launch<double>(e0, e1, e2, ext_shape, out, ivx, ivy, ivz, nz, ny, nx,
                        c, (cudaStream_t)stream);
}
