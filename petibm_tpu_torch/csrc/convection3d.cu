// 3D divergence-form convection N(u) of all three velocity components in
// one launch (kernel K3 of the port).
//
// Replaces petibm_tpu/operators/pallas_stencil.py:make_pallas_convection
// (kernel body _conv_kernel, one pallas_call per component).  Component c
// (output shape n_c = (nz, ny, nx)) reads the three ghost-extended velocity
// arrays ext[e] (shape of component e plus 2 on every axis, filled by
// BoundarySet.extend) and forms, for each direction d (array axis 2 - d),
// from 2-point face averages
//
//   d == c:  (fE * fE - fW * fW) * inv_dl_d     fW = half * (u[-1] + u) ...
//   d != c:  (advP * aP - advM * aM) * inv_dl_d aM/aP: faces of u_c along d,
//            advM/advP: u_d averaged along c at the two faces along d
//
// and sums the three terms in direction order x, y, z, as the Pallas kernel
// and the plain twin (operators/cuda_stencil.py:convection3d_apply_ref) do.
// Cell (k, j, i) of a component reads ext[e][1 + oz + k, 1 + oy + j,
// 1 + ox + i]; over the three components, with (x, y, z) offsets:
//   ext u: the 7-point stencil, (-1, +1, 0) and (-1, 0, +1);
//   ext v: the 7-point stencil, (+1, -1, 0) and (0, -1, +1);
//   ext w: the 7-point stencil, (+1, 0, -1) and (0, +1, -1).
// The source is built with --fmad=false (_kernels.EXTRA_FLAGS): every
// product and sum is rounded on its own, in the twin's order, and the
// result equals the twin's bit for bit.
//
// Bound: device-memory bandwidth.  The work that must be done is to read
// each extended array once and write each output once: 24 B a cell in
// float32, 407 MB at 256^3 (121.6 us at 3.35 TB/s); the twin's 102
// operations a cell take 25 us at 67 TFLOP/s.
//
// Design: one launch covers the union box (the largest extent of the three
// components on each axis) and marches it in z, as K1 and K2 do (march.cuh):
// a block owns a TX x TY tile of the xy plane and a chunk of kz planes (the
// plan cuts z so that the grid is one wave of the card's resident blocks;
// operators/cuda_stencil.py convection_launch_plan).
// - Shared memory (dynamic: 29,376 B a block at the float32 plan's tile,
//   32,640 B at the float64 plan's) holds, for each
//   of the three arrays, kAhead + 2 planes of the tile with a one-cell
//   border, corners included: (TY + 2) x (TX + 2) values a plane.  While
//   plane k is computed from planes k and k + 1, planes k + 2 .. k + 1 +
//   kAhead are in flight: cp.async copies them from device memory into
//   their slots without passing through registers, each thread the same
//   cells of the bordered tile every plane; one barrier a plane.  So each
//   value of each array is loaded from device memory once a block, plus
//   the border and two planes a chunk.  A first version staged one plane
//   ahead in registers, as march.cuh does: a block's plane then took
//   about its compute plus one load latency (2.35 us at 256^3).
// - A thread computes RY neighbouring rows of one column.  The values of
//   plane k it read as plane k + 1 a step before, and the face averages
//   between planes k - 1 and k, stay in registers; a value of a row the
//   thread's rows share is read once: 9 + 8 / RY shared-memory reads a
//   cell.  Every face average the twin forms more than once (at the next
//   row or plane, or in another component) is formed once: about 68 of the
//   twin's 102 operations a cell remain.  What bound the first version
//   (one row in four a thread, every term formed on its own: 17 shared
//   reads and ~95 operations a cell) was instruction issue, not bytes:
//   0.41 of the bound at the sphere's shapes and 0.55 at 256^3 (scripts/
//   bench_torch_stencil.py), and no tile did much better.
// - A cell writes component c only where it lies inside n_c (a component
//   is one shorter on its own axis past a wall).  A tile value outside an
//   array is not read: it holds 0 and feeds only cells that are not
//   written.  Coordinates come from blockIdx and the march counter; no
//   integer division per cell.  Offsets are 32-bit (arrays and the union
//   box hold fewer than 2^31 values).
// - The tile loads are scalar: extended x extents are often odd (the
//   sphere's ext u is 161 wide), so rows do not start aligned.
//
// Measured on an H100 80GB HBM3 at 700 W, median device time a step
// (chip_smoke.py phase 2): see PERF.md section 6, K3 row.

#include <cuda_runtime.h>

namespace {

// The arrays of one launch: the extended inputs (z, y, x extents), the
// outputs (their shapes n_c = extended - 2), each component's 1/dl along
// x, y and z, the union box and the chunk length.
template <typename T>
struct Args {
  const T* ext[3];
  T* out[3];
  const T* iv[3][3];  // iv[c][d]: component c's 1/dl along direction d
  int ez[3], ey[3], ex[3];
  int nz[3], ny[3], nx[3];
  int uz, uy, ux;
  int kz;
};

// the blocks of an instance an SM must hold at once (__launch_bounds__),
// in float32 and in float64: 4 blocks of 128 threads leave each 128
// registers, where ptxas takes 135 for the 32 x 16 tile of four rows a
// thread unbounded and the card holds 3 (10% slower at the sphere's
// shapes, scripts/bench_torch_stencil.py)
#define K3_MIN_BLOCKS(T, MINB32, MINB64) (sizeof(T) == 4 ? MINB32 : MINB64)

// planes of each array the block has in flight ahead of the two it
// computes from (kAhead + 2 slots a plane of each array in shared memory)
constexpr int kAhead = 2;
constexpr int kSlots = kAhead + 2;

// One value of global memory into shared memory without passing through
// registers (cp.async, cached in L1); a literal 0 where !valid (src is then
// not read).
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"((int)sizeof(T)),
               "r"(valid ? (int)sizeof(T) : 0));
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's groups of copies are in flight
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The TX x TY tile with its border at plane m of the three arrays into
// slot `slot`: each thread copies the tile cells t, t + threads, ...
// (off[e][l] is the cell's offset in a plane of array e, -1 for a cell
// outside it: 0).  Slot `slot` of array e starts at
// tile + (e * kSlots + slot) * kTile.
template <typename T, int kLoads, int kTile, int kThreads>
__device__ __forceinline__ void copy_plane(const Args<T>& a, T* tile, int m,
                                           int slot, int t,
                                           const int (&off)[3][kLoads]) {
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    // extended plane m + 1; planes past a shorter array's end hold 0
    const bool in_z = m + 1 < a.ez[e];
    const T* base = a.ext[e] + (long long)(m + 1) * a.ey[e] * a.ex[e];
    T* dst = tile + (e * kSlots + slot) * kTile;
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int cell = t + l * kThreads;
      const bool ok = in_z && off[e][l] >= 0;
      if (cell < kTile) copy_async(dst + cell, ok ? base + off[e][l] : a.ext[e],
                                   ok);
    }
  }
}

// the dynamic shared memory of an instance: the slots of the three arrays
template <typename T, int TX, int TY>
constexpr int smem_bytes() {
  return 3 * kSlots * (TY + 2) * (TX + 2) * (int)sizeof(T);
}

// A block of TX x TY / RY threads; each computes RY neighbouring rows
// (ty * RY, ..., ty * RY + RY - 1) of one column of the tile, for all three
// components.  Every face average (half * (a + b)) and square is formed
// once, from the same operands in the same order as the twin forms it,
// and used wherever the twin forms it again: at the next row (aP along y
// is aM of the row above), at the next plane (carried in registers), and
// in another component (u's aP along y is v's advP along x, v's aP along x
// is u's advP along y, u's aP and advP along z are w's advP and aP along
// x, v's aP along z is w's advP along y, w's aP along y is v's advP along
// z).  Each product, difference and sum of the terms is the twin's.
template <typename T, int TX, int TY, int RY, int MINB32, int MINB64>
__global__ void __launch_bounds__(TX * TY / RY,
                                  K3_MIN_BLOCKS(T, MINB32, MINB64))
convection3d_march(const Args<T> a) {
  constexpr int kBy = TY / RY;
  constexpr int kThreads = TX * kBy;
  constexpr int kRow = TX + 2;
  constexpr int kTile = (TY + 2) * kRow;
  constexpr int kLoads = (kTile + kThreads - 1) / kThreads;
  static_assert(kBy * RY == TY, "RY divides the tile");
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);  // [3][kSlots][kTile]
  const T half = T(0.5);

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int t = ty * TX + tx;
  // blockIdx.x walks the tiles x fastest, blockIdx.y the chunks
  const int tiles_x = (a.ux + TX - 1) / TX;
  const int by = blockIdx.x / tiles_x;
  const int i0 = (blockIdx.x - by * tiles_x) * TX, j0 = by * TY;
  const int k0 = blockIdx.y * a.kz;
  const int k1 = min(k0 + a.kz, a.uz);

  // the bordered tile's cells this thread loads: tile row r is extended
  // row j0 + r, tile column q extended column i0 + q
  int off[3][kLoads];
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    const int cell = t + l * kThreads;
    const int r = cell / kRow;
    const int y = j0 + r, x = i0 + cell - r * kRow;
#pragma unroll
    for (int e = 0; e < 3; ++e)
      off[e][l] = cell < kTile && y < a.ey[e] && x < a.ex[e]
                      ? y * a.ex[e] + x : -1;
  }

  // the thread's column and rows, and which components it writes there
  const int i = i0 + tx;
  const int jt = j0 + ty * RY;  // its first row
  bool in_x[3];
  T ivx[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    in_x[c] = i < a.nx[c];
    ivx[c] = in_x[c] ? a.iv[c][0][i] : T(0);
  }
  bool in_y[RY][3];
  T ivy[RY][3];
#pragma unroll
  for (int r = 0; r < RY; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      in_y[r][c] = in_x[c] && jt + r < a.ny[c];
      ivy[r][c] = in_y[r][c] ? a.iv[c][1][jt + r] : T(0);
    }
  // the slot of the thread's first cell; row r is s0 + r * kRow
  const int s0 = (ty * RY + 1) * kRow + tx + 1;

  // plane m goes into slot (m - k0 + 1) % kSlots: planes k0 - 1 and k0
  // (one group of copies), then planes k0 + 1 .. k0 + kAhead (a group
  // each, empty past the chunk), and the first two awaited
  copy_plane<T, kLoads, kTile, kThreads>(a, tile, k0 - 1, 0, t, off);
  copy_plane<T, kLoads, kTile, kThreads>(a, tile, k0, 1, t, off);
  commit_copies();
#pragma unroll
  for (int p = 1; p <= kAhead; ++p) {
    if (k0 + p <= k1)
      copy_plane<T, kLoads, kTile, kThreads>(a, tile, k0 + p, p + 1, t, off);
    commit_copies();
  }
  wait_copies<kAhead>();
  __syncthreads();

  // carried per row: of plane k (read as plane k + 1 a step before) u,
  // u(-1, 0), v, w, and v of the row below the first (vb); the faces
  // between planes k - 1 and k: u's aM and advM, v's aM and advM, and the
  // square of w's fW
  T cu[RY], cux[RY], cv[RY], cw[RY], vb;
  T zu[RY], zuw[RY], zv[RY], zvw[RY], zw2[RY];
  {
    const T* Up = tile;
    const T* Vp = tile + kSlots * kTile;
    const T* Wp = tile + 2 * kSlots * kTile;
    const T* U = Up + kTile;
    const T* V = Vp + kTile;
    const T* W = Wp + kTile;
    vb = V[s0 - kRow];
#pragma unroll
    for (int r = 0; r < RY; ++r) {
      const int s = s0 + r * kRow;
      cu[r] = U[s];
      cux[r] = U[s - 1];
      cv[r] = V[s];
      cw[r] = W[s];
      zu[r] = half * (Up[s] + cu[r]);
      zuw[r] = half * (Wp[s] + Wp[s + 1]);
      zv[r] = half * (Vp[s] + cv[r]);
      zvw[r] = half * (Wp[s] + Wp[s + kRow]);
      const T fW = half * (Wp[s] + cw[r]);
      zw2[r] = fW * fW;
    }
  }

  for (int k = k0; k < k1; ++k) {
    const int now = (k - k0 + 1) % kSlots, next = (k - k0 + 2) % kSlots;
    // plane k + 1 has arrived (the groups of planes k + 2 .. k + kAhead
    // may be in flight), and every thread is done with plane k - 1
    wait_copies<kAhead - 1>();
    __syncthreads();
    // plane k + 1 + kAhead into the slot of plane k - 1
    if (k + 1 + kAhead <= k1)
      copy_plane<T, kLoads, kTile, kThreads>(
          a, tile, k + 1 + kAhead, (k - k0) % kSlots, t, off);
    commit_copies();
    T ivz[3];
    bool in_z[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      in_z[c] = k < a.nz[c];
      ivz[c] = in_z[c] ? a.iv[c][2][k] : T(0);
    }
    const T* U = tile + now * kTile;
    const T* V = U + kSlots * kTile;
    const T* W = V + kSlots * kTile;
    const T* Un = tile + next * kTile;
    const T* Vn = Un + kSlots * kTile;
    const T* Wn = Vn + kSlots * kTile;
    const int top = s0 + RY * kRow;  // the row above the last
    // plane k, index r + 1 for row r (0 the row below, RY + 1 the row
    // above): the thread's column of u, v and w, u one column left
    T u0[RY + 2], v0[RY + 2], w0[RY + 2], uw[RY + 1];
    u0[0] = U[s0 - kRow];
    u0[RY + 1] = U[top];
    v0[0] = vb;
    v0[RY + 1] = V[top];
    w0[0] = W[s0 - kRow];
    w0[RY + 1] = W[top];
    uw[RY] = U[top - 1];
#pragma unroll
    for (int r = 0; r < RY; ++r) {
      u0[r + 1] = cu[r];
      v0[r + 1] = cv[r];
      w0[r + 1] = cw[r];
      uw[r] = cux[r];
    }
    // v one column right, rows -1 .. RY - 1 (index r + 1 for row r); plane
    // k + 1's v, rows -1 .. RY - 1
    T ve[RY + 1], vn[RY + 1];
#pragma unroll
    for (int r = 0; r <= RY; ++r) {
      ve[r] = V[s0 + (r - 1) * kRow + 1];
      vn[r] = Vn[s0 + (r - 1) * kRow];
    }
    // the faces between rows r - 1 and r (index r, r = 0 .. RY): u's and
    // w's along y, v's fW along y (and its square), u's advM along y (v
    // across x at row r - 1), w's advM along y (v across z at row r - 1)
    T fuy[RY + 1], fwy[RY + 1], fvy[RY + 1], fvy2[RY + 1], gv[RY + 1],
        gz[RY + 1];
#pragma unroll
    for (int r = 0; r <= RY; ++r) {
      fuy[r] = half * (u0[r] + u0[r + 1]);
      fwy[r] = half * (w0[r] + w0[r + 1]);
      fvy[r] = half * (v0[r] + v0[r + 1]);
      fvy2[r] = fvy[r] * fvy[r];
      gv[r] = half * (v0[r] + ve[r]);
      gz[r] = half * (v0[r] + vn[r]);
    }
    const int plane_out[3] = {k * a.ny[0], k * a.ny[1], k * a.ny[2]};
#pragma unroll
    for (int r = 0; r < RY; ++r) {
      const int s = s0 + r * kRow;
      const T c_u = u0[r + 1], c_v = v0[r + 1], c_w = w0[r + 1];
      const T ue = U[s + 1], vw = V[s - 1], ww = W[s - 1], we = W[s + 1];
      const T nu = Un[s], nux = Un[s - 1], nw = Wn[s];
      // faces between planes k and k + 1
      const T au = half * (c_u + nu);    // u's aP, w's advP along x
      const T auw = half * (c_w + we);   // u's advP, w's aP along x
      const T fE = half * (c_w + nw);    // w's fE
      const T fE2 = fE * fE;
      if (in_y[r][0] && in_z[0]) {
        const T fW = half * (uw[r] + c_u);
        const T fEx = half * (c_u + ue);
        T acc = (fEx * fEx - fW * fW) * ivx[0];
        acc = acc + (gv[r + 1] * fuy[r + 1] - gv[r] * fuy[r]) * ivy[r][0];
        acc = acc + (auw * au - zuw[r] * zu[r]) * ivz[0];
        a.out[0][(plane_out[0] + jt + r) * a.nx[0] + i] = acc;
      }
      if (in_y[r][1] && in_z[1]) {
        const T aM = half * (vw + c_v);
        const T advM = half * (uw[r] + uw[r + 1]);
        T acc = (fuy[r + 1] * gv[r + 1] - advM * aM) * ivx[1];
        acc = acc + (fvy2[r + 1] - fvy2[r]) * ivy[r][1];
        acc = acc + (fwy[r + 1] * gz[r + 1] - zvw[r] * zv[r]) * ivz[1];
        a.out[1][(plane_out[1] + jt + r) * a.nx[1] + i] = acc;
      }
      if (in_y[r][2] && in_z[2]) {
        const T aM = half * (ww + c_w);
        const T advM = half * (uw[r] + nux);
        T acc = (au * auw - advM * aM) * ivx[2];
        acc = acc + (gz[r + 1] * fwy[r + 1] - gz[r] * fwy[r]) * ivy[r][2];
        acc = acc + (fE2 - zw2[r]) * ivz[2];
        a.out[2][(plane_out[2] + jt + r) * a.nx[2] + i] = acc;
      }
      zu[r] = au;
      zuw[r] = auw;
      zv[r] = gz[r + 1];
      zvw[r] = fwy[r + 1];
      zw2[r] = fE2;
      cu[r] = nu;
      cux[r] = nux;
      cv[r] = vn[r + 1];
      cw[r] = nw;
    }
    vb = vn[0];
  }
}

// the tiles (TX x TY cells, RY rows a thread) the plan may ask for
// (operators/cuda_stencil.py CONVECTION_TILES, with one column a thread),
// and the blocks an SM holds at once that each is bound to in float32
// and in float64
#define K3_TILES(X) X(32, 16, 4, 4, 1) X(32, 8, 1, 2, 2)

// An instance with its dynamic shared memory allowed (above 48 KB a
// kernel must ask for it), once a process.
template <typename T, int TX, int TY, int RY, int MINB32, int MINB64>
cudaError_t prepare() {
  static cudaError_t err = cudaFuncSetAttribute(
      convection3d_march<T, TX, TY, RY, MINB32, MINB64>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T, TX, TY>());
  return err;
}

template <typename T>
int launch_tile(const Args<T>& a, int tx, int ty, int ry, int vx,
                cudaStream_t stream) {
  const unsigned tiles = (unsigned)(((a.ux + tx - 1) / tx) *
                                    ((a.uy + ty - 1) / ty));
  const dim3 grid(tiles, (unsigned)((a.uz + a.kz - 1) / a.kz));
#define K3_LAUNCH(TX, TY, RY, M32, M64)                                    \
  if (tx == TX && ty == TY && ry == RY && vx == 1) {                       \
    const cudaError_t err = prepare<T, TX, TY, RY, M32, M64>();            \
    if (err != cudaSuccess) return (int)err;                               \
    convection3d_march<T, TX, TY, RY, M32, M64>                            \
        <<<grid, dim3(TX, TY / RY), smem_bytes<T, TX, TY>(), stream>>>(a); \
    return (int)cudaGetLastError();                                        \
  }
  K3_TILES(K3_LAUNCH)
#undef K3_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The blocks of the tile's instance the current device holds at once, into
// *slots; 0 on success.
template <typename T>
int resident(int tx, int ty, int ry, int vx, int* slots) {
  int device = 0, sms = 0, per_sm = -1;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
#define K3_RESIDENT(TX, TY, RY, M32, M64)                                 \
  if (tx == TX && ty == TY && ry == RY && vx == 1) {                      \
    err = prepare<T, TX, TY, RY, M32, M64>();                             \
    if (err == cudaSuccess)                                               \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                \
          &per_sm, convection3d_march<T, TX, TY, RY, M32, M64>,           \
          TX * TY / RY, smem_bytes<T, TX, TY>());                         \
  }
  K3_TILES(K3_RESIDENT)
#undef K3_RESIDENT
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 0) return (int)cudaErrorInvalidValue;
  *slots = sms * per_sm;
  return 0;
}

// Checks the shapes and the plan (mirrored by operators/cuda_stencil.py
// convection_plan_error) and launches.  ext_shape holds the (z, y, x)
// extents of ext0, ext1 and ext2; component c's output is ext c's shape
// minus 2 on every axis.
template <typename T>
int launch(const T* e0, const T* e1, const T* e2, const long long* ext_shape,
           T* o0, T* o1, T* o2, const T* const* iv, int tx, int ty, int ry,
           int vx, int kz, cudaStream_t stream) {
  long long n[3][3], u[3] = {0, 0, 0};
  for (int e = 0; e < 3; ++e) {
    long long cells = 1;
    for (int ax = 0; ax < 3; ++ax) {
      const long long m = ext_shape[3 * e + ax];
      if (m < 3) return (int)cudaErrorInvalidValue;  // no interior
      cells *= m;
      n[e][ax] = m - 2;
      if (n[e][ax] > u[ax]) u[ax] = n[e][ax];
    }
    if (cells >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  }
  if (u[0] * u[1] * u[2] >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  // component c reads ext d (d != c) at offsets -1 and 0 along d, 0 and
  // +1 along c, 0 along the third direction
  for (int c = 0; c < 3; ++c)
    for (int d = 0; d < 3; ++d)
      for (int ax = 0; d != c && ax < 3; ++ax)
        if (ext_shape[3 * d + ax] < n[c][ax] + 1 + (ax == 2 - c ? 1 : 0))
          return (int)cudaErrorInvalidValue;
  if (kz < 1 || (u[0] + kz - 1) / kz > 65535) return (int)cudaErrorInvalidValue;
  Args<T> a;
  const T* ext[3] = {e0, e1, e2};
  T* out[3] = {o0, o1, o2};
  for (int e = 0; e < 3; ++e) {
    a.ext[e] = ext[e];
    a.out[e] = out[e];
    for (int d = 0; d < 3; ++d) a.iv[e][d] = iv[3 * e + d];
    a.ez[e] = (int)ext_shape[3 * e];
    a.ey[e] = (int)ext_shape[3 * e + 1];
    a.ex[e] = (int)ext_shape[3 * e + 2];
    a.nz[e] = (int)n[e][0];
    a.ny[e] = (int)n[e][1];
    a.nx[e] = (int)n[e][2];
  }
  a.uz = (int)u[0];
  a.uy = (int)u[1];
  a.ux = (int)u[2];
  a.kz = kz;
  return launch_tile<T>(a, tx, ty, ry, vx, stream);
}

}  // namespace

// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, 0 on success, cudaErrorInvalidValue for shapes or a plan the
// kernel does not take.  iv holds 9 device pointers, component c's 1/dl
// along x, y and z at iv[3c], iv[3c + 1], iv[3c + 2]; (tx, ty, ry, vx, kz)
// is the plan.
extern "C" int convection3d_f32(const float* e0, const float* e1,
                                const float* e2, const long long* ext_shape,
                                float* o0, float* o1, float* o2,
                                const float* const* iv, int tx, int ty,
                                int ry, int vx, int kz, void* stream) {
  return launch<float>(e0, e1, e2, ext_shape, o0, o1, o2, iv, tx, ty, ry, vx,
                       kz, (cudaStream_t)stream);
}

extern "C" int convection3d_f64(const double* e0, const double* e1,
                                const double* e2, const long long* ext_shape,
                                double* o0, double* o1, double* o2,
                                const double* const* iv, int tx, int ty,
                                int ry, int vx, int kz, void* stream) {
  return launch<double>(e0, e1, e2, ext_shape, o0, o1, o2, iv, tx, ty, ry,
                        vx, kz, (cudaStream_t)stream);
}

extern "C" int convection3d_resident_f32(int tx, int ty, int ry, int vx,
                                         int* slots) {
  return resident<float>(tx, ty, ry, vx, slots);
}

extern "C" int convection3d_resident_f64(int tx, int ty, int ry, int vx,
                                         int* slots) {
  return resident<double>(tx, ty, ry, vx, slots);
}
