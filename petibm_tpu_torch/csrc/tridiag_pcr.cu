// Batched tridiagonal solve along one axis by parallel cyclic reduction
// (kernels K6/K7 of the port).
//
// Replaces petibm_tpu/linalg/pallas_pcr.py:pcr_pallas (K6, the whole-array
// Pallas kernel, body _make_kernel) and pcr_pallas_blocked (K7, the same
// body gridded over a batch axis).  The K6/K7 split sizes the arrays to TPU
// VMEM; here one kernel serves both.  The multigrid smoother calls it on
// levels with a periodic axis (petibm_tpu_torch/linalg/mg.py _line_sweep):
//
//   a[i] x[i-1] + b[i] x[i] + c[i] x[i+1] = d[i]   along `axis`,
//
// with a[first] and c[last] ignored, as the twin tridiag_solve_pcr ignores
// them.  a, b, c, d and x are dense C-contiguous arrays of one shape.
//
// Bound: device-memory bandwidth, 5 dense transfers (4 reads, 1 write;
// 335 MB at 256^3 in float32, 0.1 ms at 3.35 TB/s), and the block-wide
// barrier of each of the ceil(log2 n) passes.  Design: a block holds whole
// lines in shared memory (pcr.cuh), reads each value once and writes each
// solution once; all passes run in shared memory.  Lines along a strided
// axis are tiled several to a block with neighbouring lines on
// neighbouring threads, so the reads coalesce by lines; lines along the
// contiguous axis coalesce by rows.  Short lines (2-4 rows on the coarse
// levels) are packed up to 64 to a block.  Lines up to pcr::kMaxLine rows.

#include "pcr.cuh"

namespace {

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
int launch(const T* a, const T* b, const T* c, const T* d, T* x, long long n0,
           long long n1, long long n2, int axis, cudaStream_t stream) {
  pcr::Lines g;
  if (!pcr::make_lines(n0, n1, n2, axis, &g)) return (int)cudaErrorInvalidValue;
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

}  // namespace

// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, 0 on success.  A 2D array is passed as n0 = 1 with axis 1 or 2.
extern "C" int tridiag_pcr_f32(const float* a, const float* b, const float* c,
                               const float* d, float* x, long long n0,
                               long long n1, long long n2, int axis,
                               void* stream) {
  return launch<float>(a, b, c, d, x, n0, n1, n2, axis, (cudaStream_t)stream);
}

extern "C" int tridiag_pcr_f64(const double* a, const double* b,
                               const double* c, const double* d, double* x,
                               long long n0, long long n1, long long n2,
                               int axis, void* stream) {
  return launch<double>(a, b, c, d, x, n0, n1, n2, axis, (cudaStream_t)stream);
}
