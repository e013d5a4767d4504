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
// Design (zblocked_helmholtz_march): 2.5D blocking.  A block owns a
// TX x TY tile of the xy plane and marches up a chunk of KZ planes in z;
// each of its TX/VX x TY/RY threads computes RY rows (ty, ty + TY/RY, ...)
// of VX neighbouring columns (the plan: operators/cuda_stencil.py
// launch_plan).
// - Each thread holds its cells' f[k-1], f[k] and f[k+1] in registers and
//   loads f[k+2] while it computes plane k (kAhead planes ahead), so every
//   value of f is loaded once a block, plus a z halo of one plane each end
//   of the chunk: (KZ + 2) / KZ.  With VX = 2 a row's two values come in
//   one 8-byte (float) or 16-byte (double) load and leave in one store.
// - The x and y neighbours come from the current plane's tile in shared
//   memory, with a one-cell halo on each side, double buffered: one block
//   barrier a plane.  The halo (2 TX + 2 TY cells) is loaded by the first
//   threads of the block, one or two cells each, for the next plane while
//   the current one is computed, as the columns are.  Which halo cell a
//   thread loads, and whether it wraps (periodic) or holds a literal 0
//   (wall), is decided once when the block starts; a ragged tile (nx or ny
//   not a multiple of TX or TY) puts its far halo right after its last
//   column or row, and its idle threads load and store nothing.
// - A thread holds its own Dx, CNx, CPx, Dy, CNy, CPy (and Sy, Sx) for the
//   whole march; Dz, CNz, CPz (and Sz) are one uniform load a plane.
// - Coordinates come from blockIdx (one division a block splits it into
//   the tile's x and y), threadIdx and the march counter: no integer
//   division per cell.  Offsets are 32-bit (fewer than 2^31 cells).
// - What bound it, as measured (scripts/bench_torch_stencil.py): the loads
//   a thread has in flight and the share of the card's blocks that run at
//   once.  One cell a thread took 68 us at 256^3 in float32; RY rows and
//   VX columns a thread put 2 to 4 loads in flight, and the plan cuts z
//   into as many chunks as fill exactly one wave of the blocks the card
//   holds at once (resident_blocks below): a grid a fraction past one wave
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

namespace {

// planes of f a thread loads ahead of the plane it computes
constexpr int kAhead = 1;

template <typename T>
struct Coeffs {
  const T* d;   // diagonal part of the axis
  const T* cn;  // lower-neighbour coefficient
  const T* cp;  // upper-neighbour coefficient
};

// VX consecutive values of f at p as one load (VX * sizeof(T) bytes,
// aligned), or one value.
template <typename T, int VX>
__device__ __forceinline__ void load_x(const T* p, T (&v)[VX]) {
  static_assert(VX == 1 || VX == 2, "one value or a pair");
  if constexpr (VX == 1) {
    v[0] = *p;
  } else if constexpr (sizeof(T) == 4) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    const double2 t = *reinterpret_cast<const double2*>(p);
    v[0] = t.x; v[1] = t.y;
  }
}

template <typename T, int VX>
__device__ __forceinline__ void store_x(T* p, const T (&v)[VX]) {
  if constexpr (VX == 1) {
    *p = v[0];
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  }
}

// f at plane m (-1 <= m <= nz) of the VX columns from `col`: plane -1
// and plane nz wrap on a periodic z axis and are 0 past a wall.  m is
// uniform across the block.
template <typename T, int VX>
__device__ __forceinline__ void columns_at(const T* __restrict__ f, int m,
                                           int nz, int plane, int col,
                                           bool pz, T (&v)[VX]) {
  if (m < 0) m = pz ? nz - 1 : -1;
  else if (m >= nz) m = pz ? 0 : -1;
  if (m < 0) {
#pragma unroll
    for (int u = 0; u < VX; ++u) v[u] = T(0);
  } else {
    load_x<T, VX>(f + m * plane + col, v);
  }
}

// A tile of TX x TY cells; a block of TX / VX x TY / RY threads, each of
// which computes RY rows of the tile (rows ty, ty + TY / RY, ...) and VX
// neighbouring columns of each (loaded and stored as one vector), so that
// it has RY loads of f in flight at a time.
template <typename T, bool SCALED, int TX, int TY, int RY, int VX>
__global__ void __launch_bounds__(TX / VX * TY / RY)
zblocked_helmholtz_march(const T* __restrict__ f, T* __restrict__ out,
                         Coeffs<T> z, Coeffs<T> y, Coeffs<T> x,
                         const T* __restrict__ sz, const T* __restrict__ sy,
                         const T* __restrict__ sx, int nz, int ny, int nx,
                         int kz, bool pz, bool py, bool px) {
  constexpr int kBx = TX / VX;     // thread columns
  constexpr int kBy = TY / RY;     // thread rows
  constexpr int kThreads = kBx * kBy;
  constexpr int kRow = TX + 2;     // a tile row with its two halo cells
  static_assert(kBy * RY == TY && kBx * VX == TX, "RY, VX divide the tile");
  // halo cells a thread loads at most
  constexpr int kHalo = (2 * (TX + TY) + kThreads - 1) / kThreads;
  __shared__ T tile[2][(TY + 2) * kRow];

  const int tx = threadIdx.x, ty = threadIdx.y;
  // blockIdx.x walks the tiles x fastest, blockIdx.y the chunks
  const int tiles_x = (nx + TX - 1) / TX;
  const int by = blockIdx.x / tiles_x;
  const int i0 = (blockIdx.x - by * tiles_x) * TX, j0 = by * TY;
  const int k0 = blockIdx.y * kz;
  const int k1 = min(k0 + kz, nz);
  const int w = min(TX, nx - i0), h = min(TY, ny - j0);
  const int plane = ny * nx;
  const int i = i0 + tx * VX;  // the thread's first column

  // this thread's halo cells, t = its index + e * the block's threads: the
  // slot in the tile, the offset in a plane, and whether it is read (an
  // inner or wrapped neighbour) or a literal 0 (past a wall); slot -1 for
  // none
  int hslot[kHalo], hoff[kHalo];
  bool hread[kHalo];
#pragma unroll
  for (int e = 0; e < kHalo; ++e) {
    const int t = ty * kBx + tx + e * kThreads;
    hslot[e] = -1;
    hoff[e] = 0;
    hread[e] = false;
    if (t < 2 * h) {  // the columns left and right of the tile
      const int r = t < h ? t : t - h;
      const int ih = t < h ? i0 - 1 : i0 + w;
      hslot[e] = (r + 1) * kRow + (t < h ? 0 : w + 1);
      hread[e] = (ih >= 0 && ih < nx) || px;
      hoff[e] = (j0 + r) * nx + (ih < 0 ? nx - 1 : ih >= nx ? 0 : ih);
    } else if (t < 2 * h + 2 * w) {  // the rows below and above the tile
      const int c = t < 2 * h + w ? t - 2 * h : t - 2 * h - w;
      const int jh = t < 2 * h + w ? j0 - 1 : j0 + h;
      hslot[e] = (t < 2 * h + w ? 0 : h + 1) * kRow + c + 1;
      hread[e] = (jh >= 0 && jh < ny) || py;
      hoff[e] = (jh < 0 ? ny - 1 : jh >= ny ? 0 : jh) * nx + i0 + c;
    }
  }

  // the x coefficients of the thread's columns (with VX > 1 the C entry
  // takes only nx a multiple of VX, so a thread's columns are all in the
  // array or all past it)
  T dx[VX], cnx[VX], cpx[VX], sxi[VX];
#pragma unroll
  for (int u = 0; u < VX; ++u) {
    dx[u] = cnx[u] = cpx[u] = sxi[u] = T(0);
    if (tx * VX < w) {
      dx[u] = __ldg(x.d + i + u); cnx[u] = __ldg(x.cn + i + u);
      cpx[u] = __ldg(x.cp + i + u);
      if (SCALED) sxi[u] = __ldg(sx + i + u);
    }
  }
  // per row r: whether its cells are in the array, its offset in a plane
  // and slot in the tile, its y coefficients, and its columns:
  // q[r][a][u] is column u's f[k-1+a] when plane k starts (a <= kAhead+1);
  // q[r][kAhead+2] takes f[k+kAhead+1], loaded during plane k
  bool active[RY];
  int col[RY], slot[RY];
  T dy[RY], cny[RY], cpy[RY], syj[RY];
  T q[RY][kAhead + 3][VX];
#pragma unroll
  for (int r = 0; r < RY; ++r) {
    const int jr = ty + r * kBy;
    const int j = j0 + jr;
    active[r] = tx * VX < w && jr < h;
    col[r] = j * nx + i;
    slot[r] = (jr + 1) * kRow + tx * VX + 1;
    dy[r] = cny[r] = cpy[r] = syj[r] = T(0);
    if (active[r]) {
      dy[r] = __ldg(y.d + j); cny[r] = __ldg(y.cn + j);
      cpy[r] = __ldg(y.cp + j);
      if (SCALED) syj[r] = __ldg(sy + j);
    }
#pragma unroll
    for (int a = 0; a < kAhead + 2; ++a) {
      if (active[r] && k0 - 1 + a <= k1) {
        columns_at<T, VX>(f, k0 - 1 + a, nz, plane, col[r], pz, q[r][a]);
      } else {
#pragma unroll
        for (int u = 0; u < VX; ++u) q[r][a][u] = T(0);
      }
    }
  }
  T halo[kHalo];
#pragma unroll
  for (int e = 0; e < kHalo; ++e)
    halo[e] = kAhead > 0 && hread[e] ? f[k0 * plane + hoff[e]] : T(0);

  for (int k = k0; k < k1; ++k) {
    const int buf = (k - k0) & 1;
    // the loads for the planes ahead, issued before this plane's barrier
#pragma unroll
    for (int r = 0; r < RY; ++r) {
      if (active[r] && k + kAhead + 1 <= k1) {
        columns_at<T, VX>(f, k + kAhead + 1, nz, plane, col[r], pz,
                          q[r][kAhead + 2]);
      } else {
#pragma unroll
        for (int u = 0; u < VX; ++u) q[r][kAhead + 2][u] = T(0);
      }
    }
    T halo_next[kHalo];
#pragma unroll
    for (int e = 0; e < kHalo; ++e) {
      halo_next[e] = T(0);
      if (kAhead == 0) {
        if (hread[e]) halo[e] = f[k * plane + hoff[e]];
      } else if (hread[e] && k + 1 < k1) {
        halo_next[e] = f[(k + 1) * plane + hoff[e]];
      }
    }
    const T dz = __ldg(z.d + k), cnz = __ldg(z.cn + k), cpz = __ldg(z.cp + k);
    const T szk = SCALED ? __ldg(sz + k) : T(0);

#pragma unroll
    for (int r = 0; r < RY; ++r)
      if (active[r]) {
#pragma unroll
        for (int u = 0; u < VX; ++u) tile[buf][slot[r] + u] = q[r][1][u];
      }
#pragma unroll
    for (int e = 0; e < kHalo; ++e)
      if (hslot[e] >= 0) tile[buf][hslot[e]] = halo[e];
    __syncthreads();
    const T* s = tile[buf];
#pragma unroll
    for (int r = 0; r < RY; ++r) {
      if (active[r]) {
        T acc[VX];
#pragma unroll
        for (int u = 0; u < VX; ++u) {
          const int c = slot[r] + u;
          acc[u] = q[r][1][u] * ((dz + dy[r]) + dx[u]);
          acc[u] = acc[u] + cnz * q[r][0][u];
          acc[u] = acc[u] + cpz * q[r][2][u];
          acc[u] = acc[u] + cny[r] * s[c - kRow];
          acc[u] = acc[u] + cpy[r] * s[c + kRow];
          acc[u] = acc[u] + cnx[u] * s[c - 1];
          acc[u] = acc[u] + cpx[u] * s[c + 1];
          if (SCALED) acc[u] = acc[u] * ((szk * syj[r]) * sxi[u]);
        }
        store_x<T, VX>(out + k * plane + col[r], acc);
      }
#pragma unroll
      for (int a = 0; a < kAhead + 2; ++a)
#pragma unroll
        for (int u = 0; u < VX; ++u) q[r][a][u] = q[r][a + 1][u];
    }
#pragma unroll
    for (int e = 0; e < kHalo; ++e) halo[e] = halo_next[e];
  }
}

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

struct Args {
  long long nz, ny, nx;
  bool pz, py, px;
};

template <typename T, bool SCALED, int TX, int TY, int RY, int VX>
int launch_march(const T* f, T* out, Coeffs<T> z, Coeffs<T> y, Coeffs<T> x,
                 const T* sz, const T* sy, const T* sx, const Args& a, int kz,
                 cudaStream_t stream) {
  const dim3 grid((unsigned)(((a.nx + TX - 1) / TX) * ((a.ny + TY - 1) / TY)),
                  (unsigned)((a.nz + kz - 1) / kz));
  zblocked_helmholtz_march<T, SCALED, TX, TY, RY, VX>
      <<<grid, dim3(TX / VX, TY / RY), 0, stream>>>(
          f, out, z, y, x, sz, sy, sx, (int)a.nz, (int)a.ny, (int)a.nx, kz,
          a.pz, a.py, a.px);
  return (int)cudaGetLastError();
}

// the tiles (TX x TY cells, RY rows and VX columns a thread) the plan may
// ask for (operators/cuda_stencil.py TILES)
#define ZB_TILES(X) X(64, 8, 2, 2) X(32, 16, 4, 2) X(32, 16, 4, 1)

template <typename T, bool SCALED>
int launch_tile(const T* f, T* out, Coeffs<T> z, Coeffs<T> y, Coeffs<T> x,
                const T* sz, const T* sy, const T* sx, const Args& a, int tx,
                int ty, int ry, int vx, int kz, cudaStream_t stream) {
#define ZB_LAUNCH(TX, TY, RY, VX)                                           \
  if (tx == TX && ty == TY && ry == RY && vx == VX)                         \
    return launch_march<T, SCALED, TX, TY, RY, VX>(f, out, z, y, x, sz, sy, \
                                                   sx, a, kz, stream);
  ZB_TILES(ZB_LAUNCH)
#undef ZB_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The blocks of the tile's instance the current device holds at once
// (its SMs times the blocks an SM holds, from the instance's registers and
// shared memory), into *slots; 0 on success.
template <typename T, bool SCALED>
int resident(int tx, int ty, int ry, int vx, int* slots) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
#define ZB_RESIDENT(TX, TY, RY, VX)                                     \
  if (tx == TX && ty == TY && ry == RY && vx == VX)                     \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                \
        &per_sm, zblocked_helmholtz_march<T, SCALED, TX, TY, RY, VX>,   \
        TX / VX * TY / RY, 0);                                          \
  else
  ZB_TILES(ZB_RESIDENT) return (int)cudaErrorInvalidValue;
#undef ZB_RESIDENT
  *slots = sms * per_sm;
  return (int)err;
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
  if (nz < 0 || ny < 0 || nx < 0) return (int)cudaErrorInvalidValue;
  if (nz == 0 || ny == 0 || nx == 0) return 0;
  if (nz * ny * nx >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (kz < 1 || (nz + kz - 1) / kz > 65535) return (int)cudaErrorInvalidValue;
  // a vector tile loads and stores VX values at once: nx a multiple of VX,
  // f and out aligned to the vector
  const unsigned long long align = (unsigned long long)vx * sizeof(T);
  if (vx > 1 && (nx % vx != 0 ||
                 ((unsigned long long)f | (unsigned long long)out) % align))
    return (int)cudaErrorInvalidValue;
  const bool scaled = sz != nullptr;
  if (scaled != (sy != nullptr) || scaled != (sx != nullptr))
    return (int)cudaErrorInvalidValue;
  const Coeffs<T> z{dz, cnz, cpz}, y{dy, cny, cpy}, x{dx, cnx, cpx};
  const Args a{nz, ny, nx, pz != 0, py != 0, px != 0};
  if (scaled)
    return launch_tile<T, true>(f, out, z, y, x, sz, sy, sx, a, tx, ty, ry,
                                vx, kz, stream);
  return launch_tile<T, false>(f, out, z, y, x, sz, sy, sx, a, tx, ty, ry,
                               vx, kz, stream);
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
  return scaled ? resident<float, true>(tx, ty, ry, vx, slots)
                : resident<float, false>(tx, ty, ry, vx, slots);
}

extern "C" int zblocked_helmholtz_resident_f64(int scaled, int tx, int ty,
                                               int ry, int vx, int* slots) {
  return scaled ? resident<double, true>(tx, ty, ry, vx, slots)
                : resident<double, false>(tx, ty, ry, vx, slots);
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
