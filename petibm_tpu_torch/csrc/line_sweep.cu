// One damped line-Jacobi sweep of the multigrid smoother along one axis
// of a non-periodic level (kernels K4/K5 of the port).
//
// Replaces petibm_tpu/linalg/pallas_sweep.py:fused_sweep (K4, the
// whole-array Pallas kernel, body _make_sweep_kernel) and
// fused_sweep_blocked (K5, the same sweep gridded along a batch axis, whose
// coupling the caller adds to the right side first).  The K4/K5 split
// sizes the arrays to TPU VMEM; here one kernel serves both and builds
// every axis's coupling itself.  The sweep solves, for each line along the
// line direction d, the area-rescaled system of sweep_aux
// (petibm_tpu_torch/linalg/cuda_sweep.py):
//
//   sub/super-diagonal  a_lo[i] = -c_d[i],  c_hi[i] = -c_d[i+1]
//   diagonal            diag_line[i] + w_line[i] * s_batch[line]
//   right side          rhs * inv_area[line]
//                       + sum_e (w_line[i] * inv_w_e) * (c_lo_e phi[-1] + c_hi_e phi[+1])
//
// over the other axes e in descending order, by PCR (pcr.cuh), then writes
// out = phi + omega * (x - phi).
//
// Bound: device-memory bandwidth.  The dense traffic is read phi, read
// rhs, write out (three transfers, as the Pallas kernel has; 32 MB at the
// sphere's 130x130x160 level in float32, 10 us at 3.35 TB/s); the
// neighbour reads of phi along the other axes hit L1/L2, and the 1D
// factors and the batch-shaped inv_area and s_batch are a few KB.  Design:
// the tiling of tridiag_pcr.cu; each thread builds its values' right sides
// and diagonals while loading, keeps phi in registers, runs the PCR passes
// in shared memory and writes the damped update once.

#include "pcr.cuh"

namespace {

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

template <typename T>
__global__ void __launch_bounds__(pcr::kMaxThreads)
    line_sweep_kernel(const T* __restrict__ phi, const T* __restrict__ rhs,
                      T* __restrict__ out, Factors<T> f, pcr::Lines g,
                      T omega) {
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
int launch(const T* phi, const T* rhs, T* out, const T* const* vec,
           long long n0, long long n1, long long n2, int axis, double omega,
           cudaStream_t stream) {
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
  static bool allowed = false;
  if (!allowed) {
    cudaError_t err = pcr::allow_shared(line_sweep_kernel<T>, sizeof(T));
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  line_sweep_kernel<T><<<(unsigned)pcr::blocks(g), g.threads,
                         pcr::shared_bytes<T>(g), stream>>>(phi, rhs, out, f, g,
                                                            (T)omega);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, 0 on success.  `vec` holds 15 device pointers: a_lo, c_hi,
// diag_line, w_line, inv_area, s_batch, then (c_lo, c_hi, inv_w) of array
// axes 0, 1 and 2, null for the line axis and for the absent axis 0 of a
// 2D level (passed as n0 = 1, line axis 1 or 2).
extern "C" int line_sweep_f32(const float* phi, const float* rhs, float* out,
                              const float* const* vec, long long n0,
                              long long n1, long long n2, int axis,
                              double omega, void* stream) {
  return launch<float>(phi, rhs, out, vec, n0, n1, n2, axis, omega,
                       (cudaStream_t)stream);
}

extern "C" int line_sweep_f64(const double* phi, const double* rhs,
                              double* out, const double* const* vec,
                              long long n0, long long n1, long long n2,
                              int axis, double omega, void* stream) {
  return launch<double>(phi, rhs, out, vec, n0, n1, n2, axis, omega,
                        (cudaStream_t)stream);
}
