// The z march shared by the 3D 7-point stencils K1 (poisson_separable.cu)
// and K2 (zblocked_helmholtz.cu): a block owns a TX x TY tile of the xy
// plane and marches up a chunk of kz planes in z; each of its TX/VX x
// TY/RY threads computes RY rows (ty, ty + TY/RY, ...) of VX neighbouring
// columns (the plan: operators/cuda_stencil.py launch_plan).
// - Each thread holds its cells' f[k-1], f[k] and f[k+1] in registers and
//   loads f[k+2] while it computes plane k (kAhead planes ahead), so every
//   value of f is loaded once a block, plus a z halo of one plane each end
//   of the chunk: (kz + 2) / kz.  With VX = 2 a row's two values come in
//   one 8-byte (float), 16-byte (double) or 4-byte (bf16, bf16.cuh) load
//   and leave in one store.
// - The x and y neighbours come from the current plane's tile in shared
//   memory, with a one-cell halo on each side, double buffered: one block
//   barrier a plane.  The halo (2 TX + 2 TY cells) is loaded by the first
//   threads of the block, one or two cells each, for the next plane while
//   the current one is computed, as the columns are.  Which halo cell a
//   thread loads, and whether it wraps (periodic) or holds a literal 0
//   (wall), is decided once when the block starts; a ragged tile (nx or ny
//   not a multiple of TX or TY) puts its far halo right after its last
//   column or row, and its idle threads load and store nothing.  Past a
//   wall nothing outside the array is read.
// - Coordinates come from blockIdx (one division a block splits it into
//   the tile's x and y), threadIdx and the march counter: no integer
//   division per cell.  Offsets are 32-bit (fewer than 2^31 cells).
//
// What a cell computes is the Body, a struct with
//   Params                 the kernel's coefficient pointers;
//   X, Y, Z                the coefficients of a column, a row and a plane
//                          (zero-initialised for idle threads);
//   x_at(p, i), y_at(p, j), z_at(p, k)
//                          load them: a thread loads its columns' and rows'
//                          once, a plane's once a plane (uniform loads);
//   apply(z, y, x, c, zlo, zhi, ylo, yhi, xlo, xhi)
//                          the cell from its value and its six neighbours.
// The instances are the tiles of ZB_TILES; resident() asks the CUDA
// occupancy calculator how many blocks of one the card holds at once.

#pragma once

#include <cuda_runtime.h>

#include "bf16.cuh"

namespace {

// planes of f a thread loads ahead of the plane it computes
constexpr int kAhead = 1;

// Two two-byte values (bf16) as one 4-byte load or store.
template <typename T>
struct __align__(4) Pair2 {
  T x, y;
};

// VX consecutive values of f at p as one load (VX * sizeof(T) bytes,
// aligned), or one value.
template <typename T, int VX>
__device__ __forceinline__ void load_x(const T* p, T (&v)[VX]) {
  static_assert(VX == 1 || VX == 2, "one value or a pair");
  if constexpr (VX == 1) {
    v[0] = *p;
  } else if constexpr (sizeof(T) == 2) {
    const Pair2<T> t = *reinterpret_cast<const Pair2<T>*>(p);
    v[0] = t.x; v[1] = t.y;
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
  } else if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<Pair2<T>*>(p) = Pair2<T>{v[0], v[1]};
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
template <typename T, typename Body, int TX, int TY, int RY, int VX>
__global__ void __launch_bounds__(TX / VX * TY / RY)
zmarch(const T* __restrict__ f, T* __restrict__ out,
       typename Body::Params prm, int nz, int ny, int nx, int kz, bool pz,
       bool py, bool px) {
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
  typename Body::X cx[VX];
#pragma unroll
  for (int u = 0; u < VX; ++u)
    cx[u] = tx * VX < w ? Body::x_at(prm, i + u) : typename Body::X{};
  // per row r: whether its cells are in the array, its offset in a plane
  // and slot in the tile, its y coefficients, and its columns:
  // q[r][a][u] is column u's f[k-1+a] when plane k starts (a <= kAhead+1);
  // q[r][kAhead+2] takes f[k+kAhead+1], loaded during plane k
  bool active[RY];
  int col[RY], slot[RY];
  typename Body::Y cy[RY];
  T q[RY][kAhead + 3][VX];
#pragma unroll
  for (int r = 0; r < RY; ++r) {
    const int jr = ty + r * kBy;
    const int j = j0 + jr;
    active[r] = tx * VX < w && jr < h;
    col[r] = j * nx + i;
    slot[r] = (jr + 1) * kRow + tx * VX + 1;
    cy[r] = active[r] ? Body::y_at(prm, j) : typename Body::Y{};
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
    const typename Body::Z cz = Body::z_at(prm, k);

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
          acc[u] = Body::apply(cz, cy[r], cx[u], q[r][1][u], q[r][0][u],
                               q[r][2][u], s[c - kRow], s[c + kRow],
                               s[c - 1], s[c + 1]);
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

// the extents of the field and its periodic axes
struct MarchShape {
  long long nz, ny, nx;
  bool pz, py, px;
};

template <typename T, typename Body, int TX, int TY, int RY, int VX>
int launch_march(const T* f, T* out, const typename Body::Params& prm,
                 const MarchShape& a, int kz, cudaStream_t stream) {
  const dim3 grid((unsigned)(((a.nx + TX - 1) / TX) * ((a.ny + TY - 1) / TY)),
                  (unsigned)((a.nz + kz - 1) / kz));
  zmarch<T, Body, TX, TY, RY, VX><<<grid, dim3(TX / VX, TY / RY), 0, stream>>>(
      f, out, prm, (int)a.nz, (int)a.ny, (int)a.nx, kz, a.pz, a.py, a.px);
  return (int)cudaGetLastError();
}

// the tiles (TX x TY cells, RY rows and VX columns a thread) the plan may
// ask for (operators/cuda_stencil.py TILES)
#define ZB_TILES(X) X(64, 8, 2, 2) X(32, 16, 4, 2) X(32, 16, 4, 1)

template <typename T, typename Body>
int launch_tile(const T* f, T* out, const typename Body::Params& prm,
                const MarchShape& a, int tx, int ty, int ry, int vx, int kz,
                cudaStream_t stream) {
#define ZB_LAUNCH(TX, TY, RY, VX)                                        \
  if (tx == TX && ty == TY && ry == RY && vx == VX)                      \
    return launch_march<T, Body, TX, TY, RY, VX>(f, out, prm, a, kz, stream);
  ZB_TILES(ZB_LAUNCH)
#undef ZB_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The blocks of the tile's instance the current device holds at once
// (its SMs times the blocks an SM holds, from the instance's registers and
// shared memory), into *slots; 0 on success.
template <typename T, typename Body>
int resident(int tx, int ty, int ry, int vx, int* slots) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
#define ZB_RESIDENT(TX, TY, RY, VX)                                     \
  if (tx == TX && ty == TY && ry == RY && vx == VX)                     \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                \
        &per_sm, zmarch<T, Body, TX, TY, RY, VX>, TX / VX * TY / RY, 0); \
  else
  ZB_TILES(ZB_RESIDENT) return (int)cudaErrorInvalidValue;
#undef ZB_RESIDENT
  *slots = sms * per_sm;
  return (int)err;
}

// Whether the march takes a field of nz x ny x nx cells at f (out) with
// vectors of vx columns and chunks of kz planes: 0 to launch, -1 for
// nothing to launch, cudaErrorInvalidValue for a shape or plan it does not
// take (mirrored by operators/cuda_stencil.py plan_error, but for the
// pointers' alignment; the tile is checked by launch_tile).
template <typename T>
int check_march(const T* f, const T* out, long long nz, long long ny,
                long long nx, int vx, int kz) {
  if (nz < 0 || ny < 0 || nx < 0) return (int)cudaErrorInvalidValue;
  if (nz == 0 || ny == 0 || nx == 0) return -1;
  if (nz * ny * nx >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (kz < 1 || (nz + kz - 1) / kz > 65535) return (int)cudaErrorInvalidValue;
  // a vector tile loads and stores VX values at once: nx a multiple of VX,
  // f and out aligned to the vector
  const unsigned long long align = (unsigned long long)vx * sizeof(T);
  if (vx > 1 && (nx % vx != 0 ||
                 ((unsigned long long)f | (unsigned long long)out) % align))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace
