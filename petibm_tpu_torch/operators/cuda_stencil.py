"""Hand-written CUDA kernels for the hot stencil operations.

Counterpart of ``petibm_tpu/operators/pallas_stencil.py``.  Three kernels:

- K1 ``poisson_apply_separable`` (``csrc/poisson_separable.cu``): the
  separable apply of the negated pressure operator -D B1 G on non-periodic
  2D/3D grids, the residual operator of the pressure refinement loop and
  the multigrid's finest-level operator;
- K2 ``zblocked_helmholtz_apply`` (``csrc/zblocked_helmholtz.cu``): the 3D
  7-point apply with per-axis 1D coefficients and periodic wrap, used as
  K2a, the implicit momentum operator (``make_cuda_momentum``), and as K2b,
  the scaled conservative Poisson apply of 3D grids with a periodic axis
  (``make_cuda_poisson_zblocked``);
- K3 ``convection3d_apply`` (``csrc/convection3d.cu``): the 3D
  divergence-form convection of the three velocity components, in one
  launch, from the three ghost-extended velocity arrays
  (``make_cuda_convection``).

K1's 3D path and K2 share one kernel design, the z march of
``csrc/march.cuh``, and its launch plan (``launch_plan``); K3 marches
its own tiles of three arrays (``convection_launch_plan``, on the same
``plan_for_tile``).  Each wrapper
launches its kernel on a CUDA tensor (one more in its ``launches``
counter) and calls its plain PyTorch twin (``*_ref``) on a CPU tensor;
it never falls back from one to the other on failure.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from .._kernels import (c_function, check_dtype, check_launchable,
                        check_vectors, count_launch, ptr, stream)
from ..linalg.mg import Level
from ..linalg.tridiag import shift
from ..types import Field
from .stencil import VEL_NAMES


# ----------------------------------------------------------------------
# The z march of csrc/march.cuh: the launch plan of K1's 3D path and of
# K2

class Plan(NamedTuple):
    """How the march covers one shape: each block owns a tile of ``tx`` x
    ``ty`` cells of the xy plane and a chunk of ``kz`` planes in z, with
    ``tx / vx`` x ``ty / ry`` threads that compute ``ry`` rows and ``vx``
    neighbouring columns of the tile each (a vector load and store of
    ``vx`` values)."""
    tx: int
    ty: int
    ry: int
    vx: int
    kz: int


#: the tiles (TX, TY, RY, VX) the march has instances of (``ZB_TILES``),
#: in the order ``launch_plan`` prefers them: the first whose width
#: divides nx (no block is ragged in x) and whose vector the field takes,
#: else the last (one column a thread), which takes any field
TILES = ((64, 8, 2, 2), (32, 16, 4, 2), (32, 16, 4, 1))
#: the most chunks the kernel's grid takes (its y extent)
MAX_CHUNKS = 65535


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def grid(shape, plan: Plan) -> tuple:
    """The blocks of ``plan`` on the 3D ``shape``: (tiles along x, tiles
    along y, chunks along z); block (bx, by, bz) computes x in
    [bx tx, bx tx + tx), y in [by ty, by ty + ty) and z in
    [bz kz, bz kz + kz), each cut at the array's end.  The kernel's grid
    is (tiles along x times tiles along y, chunks)."""
    nz, ny, nx = shape
    return (_ceil(nx, plan.tx), _ceil(ny, plan.ty), _ceil(nz, plan.kz))


def plan_for_tile(shape, tile, slots: int) -> Plan:
    """The plan with ``tile`` for a field of the 3D ``shape`` on a card
    that holds ``slots`` blocks of the tile's instance at once: z cut into
    chunks of equal length (the last one shorter), as many as keep the
    grid within ``slots`` blocks, so that every block starts at once and
    none waits for another to end; one chunk if a plane's tiles alone
    exceed ``slots``."""
    nz, ny, nx = shape
    if min(shape) < 1:
        return Plan(*tile, 1)
    chunks = max(1, min(nz, slots // (_ceil(nx, tile[0])
                                      * _ceil(ny, tile[1]))))
    return Plan(*tile, _ceil(nz, chunks))


def launch_plan(shape, dtype, slots, align: int) -> Plan:
    """The plan for a field of the 3D ``shape`` and ``dtype`` whose data
    (and output) start at a multiple of ``align`` bytes: the first tile of
    ``TILES`` that fits the field (its width divides nx, its vector of
    ``vx`` values divides nx and ``align``), else the last; and
    ``plan_for_tile``'s chunks for ``slots(tile)`` blocks held at once
    (``resident_blocks``, ``separable_resident_blocks``)."""
    nx = shape[2]
    size = torch.finfo(dtype).bits // 8
    *first, last = TILES
    tile = next((t for t in first if nx % t[0] == 0 and nx % t[3] == 0
                 and align % (t[3] * size) == 0), last)
    return plan_for_tile(shape, tile, slots(tile))


def plan_error(shape, plan: Plan):
    """Why K1's or K2's C entry refuses ``plan`` for the 3D ``shape`` (it
    returns cudaErrorInvalidValue and the wrapper raises), or None when it
    takes it: the conditions of ``check_march`` and ``launch_tile`` in
    ``csrc/march.cuh``, but for one on the pointers: a vector tile also
    needs f and out aligned to its vector."""
    nz, ny, nx = shape
    if min(shape) < 0:
        return "a negative extent"
    if min(shape) == 0:
        return None  # nothing to launch
    if nz * ny * nx >= 2 ** 31:
        return "2^31 cells or more (32-bit offsets)"
    if plan.kz < 1 or _ceil(nz, plan.kz) > MAX_CHUNKS:
        return f"chunks of no plane, or more than {MAX_CHUNKS} of them"
    if tuple(plan[:4]) not in TILES:
        return f"no instance of the tile {tuple(plan[:4])}"
    if nx % plan.vx:
        return f"a vector of {plan.vx} columns for an x extent of {nx}"
    return None


def _resident(source: str, entry: str, device, dtype, head: tuple,
              tile) -> int:
    """The blocks of the march instance of ``tile`` that ``device`` holds
    at once, from the C entry ``<entry>_<dtype>`` of ``csrc/<source>.cu``
    called with ``head`` and the tile (the CUDA occupancy calculator: its
    SMs times the blocks an SM holds at the instance's registers and
    shared memory).  Asked of the card once per instance."""
    key = (entry, torch.device(device), dtype, head, tuple(tile))
    slots = _RESIDENT.get(key)
    if slots is None:
        fn = c_function(source, entry, dtype,
                        [ctypes.c_int] * (len(head) + 4)
                        + [ctypes.POINTER(ctypes.c_int)])
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = fn(*head, *tile, ctypes.byref(out))
        if err != 0 or out.value < 1:
            raise RuntimeError(f"the occupancy query of {source} failed "
                               f"with CUDA error {err} ({out.value} blocks)")
        slots = _RESIDENT[key] = out.value
    return slots


_RESIDENT: dict = {}


def _plan_on_card(f: torch.Tensor, slots) -> Plan:
    """``launch_plan`` for the CUDA field ``f`` (its output comes from
    ``torch.empty_like``, aligned to at least 256 bytes) with
    ``slots(tile)`` blocks held at once."""
    ptr_f = f.data_ptr()
    return launch_plan(f.shape, f.dtype, slots,
                       (ptr_f & -ptr_f) if ptr_f else 256)


# ----------------------------------------------------------------------
# K1: separable Poisson apply (non-periodic)

def poisson_apply_separable_ref(phi: torch.Tensor, level: Level) -> torch.Tensor:
    """Plain PyTorch twin of K1: sum_d area_d * (a_d*phi - c_lo_d*phi[i-1]
    - c_hi_d*phi[i+1]) with every coefficient formed from the 1D factors
    in the working dtype, exactly as the kernel forms them."""
    ndim = phi.ndim
    out = None
    for d in range(ndim):
        axis = ndim - 1 - d
        c = level.c1d[d]
        n = c.shape[0] - 1
        c_lo = c[:-1].reshape(level.bshape(d, n))
        c_hi = c[1:].reshape(level.bshape(d, n))
        area = None
        for e in range(ndim):
            if e == d:
                continue
            w = level.w1d[e].reshape(level.bshape(e, level.w1d[e].shape[0]))
            area = w if area is None else area * w
        term = ((c_lo + c_hi) * phi - c_lo * shift(phi, 1, axis)
                - c_hi * shift(phi, -1, axis))
        term = area * term
        out = term if out is None else out + term
    return out


def _check_k1(phi: torch.Tensor, level: Level) -> None:
    if phi.ndim not in (2, 3) or phi.ndim != len(level.shape):
        raise ValueError(f"K1 takes a 2D or 3D field matching the level, got "
                         f"shape {tuple(phi.shape)} for level {level.shape}")
    if tuple(phi.shape) != tuple(level.shape):
        raise ValueError(f"field shape {tuple(phi.shape)} != level shape "
                         f"{tuple(level.shape)}")
    if any(level.periodic):
        raise ValueError("K1 applies non-periodic grids only")
    check_dtype("K1", phi, bf16=True)
    check_vectors("K1", phi, (*level.c1d, *level.w1d))


def separable_resident_blocks(device, dtype, tile) -> int:
    """The blocks of K1's march instance of ``tile`` (``dtype``) that
    ``device`` holds at once (``_resident``)."""
    return _resident("poisson_separable", "poisson_apply_separable_resident",
                     device, dtype, (), tile)


def separable_plan_on_card(phi: torch.Tensor) -> Plan:
    """The plan ``poisson_apply_separable`` launches for the 3D CUDA field
    ``phi``: ``launch_plan`` with K1's own resident blocks."""
    return _plan_on_card(phi, lambda tile: separable_resident_blocks(
        phi.device, phi.dtype, tile))


#: the plan arguments of a 2D launch, which the C entry does not read
_NO_PLAN = (0, 0, 0, 0, 0)


def _call_k1(entry: str, phi, level: Level, plan_args: tuple):
    fn = c_function("poisson_separable", entry, phi.dtype,
                    [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 3
                    + [ctypes.c_int] * (1 + len(plan_args))
                    + [ctypes.c_void_p])
    out = torch.empty_like(phi)
    shape = (1,) * (3 - phi.ndim) + tuple(phi.shape)
    c = list(level.c1d) + [None] * (3 - phi.ndim)
    w = list(level.w1d) + [None] * (3 - phi.ndim)
    with torch.cuda.device(phi.device):
        err = fn(ptr(phi), ptr(out), ptr(c[0]), ptr(w[0]), ptr(c[1]),
                 ptr(w[1]), ptr(c[2]), ptr(w[2]), *shape, phi.ndim,
                 *plan_args, stream(phi.device))
    if err != 0:
        why = (plan_error(shape, Plan(*plan_args))
               if phi.ndim == 3 and plan_args else None)
        raise RuntimeError(f"K1 launch failed with CUDA error {err}"
                           + (f": {why}" if why else ""))
    return out


def separable_launch(phi, level: Level, plan: Plan | None):
    """One launch of K1 on CUDA tensors that ``poisson_apply_separable``
    has checked: the 3D march with ``plan``, or the 2D cell kernel
    (``plan`` None); counts nothing (the wrapper does).  Raises when the C
    entry refuses the plan, naming ``plan_error``'s reason."""
    return _call_k1("poisson_apply_separable", phi, level,
                    _NO_PLAN if plan is None else tuple(plan))


def separable_launch_cells(phi, level: Level):
    """One launch of the one-thread-a-cell kernel in 2D or 3D (the first
    3D design), kept to be timed beside the march; counts nothing, and no
    solver calls it."""
    return _call_k1("poisson_apply_separable_cells", phi, level, ())


def poisson_apply_separable(phi: torch.Tensor, level: Level) -> torch.Tensor:
    """K1: the separable apply of the negated Poisson operator -D B1 G.

    A CUDA ``phi`` launches the kernel on the current stream (one more in
    ``poisson_apply_separable.launches``): in 3D the march with
    ``separable_plan_on_card``'s plan, in 2D one thread a cell.  A CPU
    ``phi`` runs the plain twin.  Raises on shapes, dtypes or devices the
    kernel does not take, and when the launch reports an error."""
    _check_k1(phi, level)
    if phi.device.type == "cpu":
        return poisson_apply_separable_ref(phi, level)
    check_launchable("K1", phi)
    out = separable_launch(phi, level, separable_plan_on_card(phi)
                           if phi.ndim == 3 else None)
    count_launch(poisson_apply_separable)
    return out


poisson_apply_separable.launches = 0


def make_cuda_poisson(level: Level):
    """The K1 apply for a non-periodic 2D/3D level, or None when the kernel
    does not apply (periodic wrap), as ``make_pallas_poisson`` decides
    minus its TPU-only gates (f64 refusal and VMEM cap)."""
    if len(level.shape) not in (2, 3) or any(level.periodic):
        return None

    def apply_k1(phi):
        return poisson_apply_separable(phi, level)

    return apply_k1


# ----------------------------------------------------------------------
# K2: 3D 7-point apply with per-axis 1D coefficients

#: the coefficient vectors of K2, per array axis z, y, x
ZBLOCKED_KEYS = ("Dz", "CNz", "CPz", "Dy", "CNy", "CPy", "Dx", "CNx", "CPx")


def _axis_vec(vec: torch.Tensor, axis: int) -> torch.Tensor:
    shape = [1, 1, 1]
    shape[axis] = vec.shape[0]
    return vec.reshape(shape)


def zblocked_helmholtz_apply_ref(f: torch.Tensor, vecs: dict, periodic,
                                 scale=None) -> torch.Tensor:
    """Plain PyTorch twin of K2: ``torch.roll`` on periodic axes, zero fill
    past walls, in the kernel's order of operations."""
    def nbrs(axis):
        if periodic[axis]:
            return torch.roll(f, 1, axis), torch.roll(f, -1, axis)
        return shift(f, 1, axis), shift(f, -1, axis)

    v = {k: _axis_vec(vecs[k], "zyx".index(k[-1])) for k in ZBLOCKED_KEYS}
    lo_z, hi_z = nbrs(0)
    lo_y, hi_y = nbrs(1)
    lo_x, hi_x = nbrs(2)
    out = (f * (v["Dz"] + v["Dy"] + v["Dx"])
           + v["CNz"] * lo_z + v["CPz"] * hi_z
           + v["CNy"] * lo_y + v["CPy"] * hi_y
           + v["CNx"] * lo_x + v["CPx"] * hi_x)
    if scale is not None:
        sz, sy, sx = scale
        out = out * (_axis_vec(sz, 0) * _axis_vec(sy, 1) * _axis_vec(sx, 2))
    return out


def _check_k2(f: torch.Tensor, vecs: dict, periodic, scale) -> None:
    if f.ndim != 3:
        raise ValueError(f"K2 takes a 3D field, got shape {tuple(f.shape)}")
    check_dtype("K2", f)
    if len(periodic) != 3:
        raise ValueError("K2 takes one periodic flag per axis (z, y, x)")
    vectors = [vecs[k] for k in ZBLOCKED_KEYS]
    if scale is not None:
        if len(scale) != 3:
            raise ValueError("K2's scale is three vectors (Sz, Sy, Sx)")
        vectors += list(scale)
    check_vectors("K2", f, vectors)
    lengths = {k: f.shape["zyx".index(k[-1])] for k in ZBLOCKED_KEYS}
    for key in ZBLOCKED_KEYS:
        if vecs[key].shape[0] != lengths[key]:
            raise ValueError(f"K2 vector {key} has {vecs[key].shape[0]} "
                             f"entries for an axis of {lengths[key]}")
    if scale is not None and tuple(s.shape[0] for s in scale) != tuple(f.shape):
        raise ValueError("K2's scale vectors must match the field's axes")


def resident_blocks(device, dtype, scaled: bool, tile) -> int:
    """The blocks of K2's instance of ``tile`` (``dtype``, scaled or not)
    that ``device`` holds at once (``_resident``)."""
    return _resident("zblocked_helmholtz", "zblocked_helmholtz_resident",
                     device, dtype, (int(bool(scaled)),), tile)


def plan_on_card(f: torch.Tensor, scaled: bool) -> Plan:
    """The plan ``zblocked_helmholtz_apply`` launches for the CUDA field
    ``f``."""
    return _plan_on_card(f, lambda tile: resident_blocks(f.device, f.dtype,
                                                         scaled, tile))


def _call(entry: str, f, vecs, periodic, scale, plan_args: tuple):
    ints = [ctypes.c_int] * (3 + len(plan_args))
    fn = c_function("zblocked_helmholtz", entry, f.dtype,
                    [ctypes.c_void_p] * 14 + [ctypes.c_longlong] * 3 + ints
                    + [ctypes.c_void_p])
    out = torch.empty_like(f)
    s = (None, None, None) if scale is None else scale
    with torch.cuda.device(f.device):
        err = fn(ptr(f), ptr(out), *(ptr(vecs[k]) for k in ZBLOCKED_KEYS),
                 *(ptr(t) for t in s), *f.shape,
                 *(int(bool(p)) for p in periodic), *plan_args,
                 stream(f.device))
    if err != 0:
        raise RuntimeError(f"K2 launch failed with CUDA error {err}")
    return out


def launch(f, vecs, periodic, scale, plan: Plan):
    """One launch of the march with ``plan`` on CUDA tensors that
    ``zblocked_helmholtz_apply`` has checked; counts nothing (the wrapper
    does).  Raises when the C entry refuses the plan."""
    return _call("zblocked_helmholtz", f, vecs, periodic, scale, plan)


def launch_cells(f, vecs, periodic, scale):
    """One launch of the first design (one thread per cell), kept to be
    timed beside the march; counts nothing, and no solver calls it."""
    return _call("zblocked_helmholtz_cells", f, vecs, periodic, scale, ())


def zblocked_helmholtz_apply(f: torch.Tensor, vecs: dict, periodic,
                             scale=None) -> torch.Tensor:
    """K2: out = f*(Dz+Dy+Dx) + CNz*f[k-1] + CPz*f[k+1] + ... + CPx*f[i+1],
    times Sz*Sy*Sx when ``scale`` is given.

    ``vecs`` maps ``ZBLOCKED_KEYS`` to 1D tensors along their axis;
    ``periodic`` = (pz, py, px).  A CUDA ``f`` launches the kernel with
    ``plan_on_card``'s plan on the current stream (one more in
    ``zblocked_helmholtz_apply.launches``, and in ``.scaled_launches``
    when scaled: the K2b use); a CPU ``f`` runs the plain twin.  Raises on
    what the kernel does not take and when the launch reports an
    error."""
    _check_k2(f, vecs, periodic, scale)
    if f.device.type == "cpu":
        return zblocked_helmholtz_apply_ref(f, vecs, periodic, scale)
    check_launchable("K2", f)
    out = launch(f, vecs, periodic, scale,
                 plan_on_card(f, scale is not None))
    count_launch(zblocked_helmholtz_apply)
    if scale is not None:
        count_launch(zblocked_helmholtz_apply, "scaled_launches")
    return out


zblocked_helmholtz_apply.launches = 0
zblocked_helmholtz_apply.scaled_launches = 0


def _as_vectors(vecs: dict, dtype, device) -> dict:
    return {k: torch.as_tensor(np.asarray(vecs[k], np.float64), dtype=dtype,
                               device=device) for k in ZBLOCKED_KEYS}


def _momentum_vectors(mesh, bcset, dt: float, cnu: float, c: int) -> dict:
    """K2a's float64 coefficient vectors of velocity component ``c`` for
    A u = u/dt - cnu * L u, built as ``make_pallas_momentum`` builds them
    (pallas_stencil.py:352-372): at a wall the ghost's a0 is folded into D
    and CN[0] = CP[n-1] = 0; 1/dt goes into Dz only."""
    vecs = {}
    for d in range(3):
        tag = "xyz"[d]
        line = mesh.lines[Field(c)][d]
        cn = 1.0 / (np.asarray(line.dneg()) * np.asarray(line.interior_dl))
        cp = 1.0 / (np.asarray(line.dpos()) * np.asarray(line.interior_dl))
        fold = np.zeros_like(cn)
        CN, CP = cn.copy(), cp.copy()
        if not mesh.periodic[d]:
            fold[0] = bcset.specs[(c, 2 * d + 0)].a0 * cn[0]
            fold[-1] += bcset.specs[(c, 2 * d + 1)].a0 * cp[-1]
            CN[0] = 0.0
            CP[-1] = 0.0
        ldiag = -(cn + cp) + fold
        vecs["D" + tag] = -cnu * ldiag
        vecs["CN" + tag] = -cnu * CN
        vecs["CP" + tag] = -cnu * CP
    vecs["Dz"] = vecs["Dz"] + 1.0 / dt
    return vecs


def make_cuda_momentum(mesh, bcset, dt: float, cnu: float, *,
                       dtype: torch.dtype, device):
    """K2a: the implicit momentum operator A u = u/dt - cnu*L u of every
    velocity component as one K2 apply each; a dict -> dict closure
    matching ``NavierStokesSolver.A_momentum``, or None in 2D (the JAX
    package has no 2D kernel for it).  The closure carries ``vecs`` (per
    component) and ``periodic`` for callers that drive K2 directly."""
    if mesh.dim != 3:
        return None
    periodic = (bool(mesh.periodic[2]), bool(mesh.periodic[1]),
                bool(mesh.periodic[0]))
    vecs = {VEL_NAMES[c]: _as_vectors(_momentum_vectors(mesh, bcset, dt,
                                                        cnu, c),
                                      dtype, device)
            for c in range(3)}

    def A_momentum(u):
        return {name: zblocked_helmholtz_apply(u[name], vecs[name], periodic)
                for name in vecs}

    A_momentum.vecs = vecs
    A_momentum.periodic = periodic
    return A_momentum


def _poisson_zblocked_vectors(level: Level) -> tuple[dict, tuple]:
    """K2b's float64 vectors and scale for a 3D level, built as
    ``make_pallas_poisson_zblocked`` builds them (pallas_stencil.py:406-430):
    D_d = (c[:-1]+c[1:])/w, CN_d = -c[:-1]/w, CP_d = -c[1:]/w, scale
    (w_z, w_y, w_x); the wrap coefficients of periodic axes sit in CN[0]
    and CP[n-1], walls have c = 0 there."""
    vecs, scale = {}, [None, None, None]
    for d in range(3):
        c = level.c1d[d].detach().cpu().numpy().astype(np.float64)
        w = level.w1d[d].detach().cpu().numpy().astype(np.float64)
        tag = "xyz"[d]
        vecs["D" + tag] = (c[:-1] + c[1:]) / w
        vecs["CN" + tag] = -c[:-1] / w
        vecs["CP" + tag] = -c[1:] / w
        scale[2 - d] = w
    return vecs, tuple(scale)


def make_cuda_poisson_zblocked(level: Level):
    """K2b: the scaled 3D conservative Poisson apply (equal to -D B1 G for
    BN order 1), periodic wrap included; None for a 2D level.  The apply
    carries ``vecs``, ``periodic`` and ``scale``."""
    if len(level.shape) != 3:
        return None
    dtype, device = level.c1d[0].dtype, level.c1d[0].device
    vecs64, scale64 = _poisson_zblocked_vectors(level)
    vecs = _as_vectors(vecs64, dtype, device)
    scale = tuple(torch.as_tensor(s, dtype=dtype, device=device)
                  for s in scale64)
    periodic = (bool(level.periodic[2]), bool(level.periodic[1]),
                bool(level.periodic[0]))

    def apply_k2b(phi):
        return zblocked_helmholtz_apply(phi, vecs, periodic, scale)

    apply_k2b.vecs = vecs
    apply_k2b.periodic = periodic
    apply_k2b.scale = scale
    return apply_k2b


# ----------------------------------------------------------------------
# K3: 3D divergence-form convection, all three components in one launch

def _window(ext: torch.Tensor, shape, offsets: dict) -> torch.Tensor:
    """ext[1 + o_z + k, 1 + o_y + j, 1 + o_x + i] over ``shape``;
    ``offsets`` are keyed by direction (array axis 2 - d)."""
    return ext[tuple(slice(1 + offsets.get(2 - ax, 0),
                           1 + offsets.get(2 - ax, 0) + shape[ax])
                     for ax in range(3))]


def convection3d_apply_ref(ext, c: int, inv_dl) -> torch.Tensor:
    """Plain PyTorch twin of K3: N(u)_c from the three extended velocity
    arrays ``ext`` and component c's 1D ``inv_dl`` = (1/dx, 1/dy, 1/dz),
    in the kernel's order of operations (equal to
    ``operators/convection.py``'s closure)."""
    shape = tuple(s - 2 for s in ext[c].shape)
    total = None
    for d in range(3):
        iv = _axis_vec(inv_dl[d], 2 - d)
        um = _window(ext[c], shape, {d: -1})
        u0 = _window(ext[c], shape, {})
        up = _window(ext[c], shape, {d: 1})
        if d == c:
            fW = 0.5 * (um + u0)
            fE = 0.5 * (u0 + up)
            term = (fE * fE - fW * fW) * iv
        else:
            aM = 0.5 * (um + u0)
            aP = 0.5 * (u0 + up)
            advM = 0.5 * (_window(ext[d], shape, {d: -1, c: 0})
                          + _window(ext[d], shape, {d: -1, c: 1}))
            advP = 0.5 * (_window(ext[d], shape, {d: 0, c: 0})
                          + _window(ext[d], shape, {d: 0, c: 1}))
            term = (advP * aP - advM * aM) * iv
        total = term if total is None else total + term
    return total


#: the tiles (TX, TY, RY, VX) K3 has instances of (``K3_TILES`` in
#: ``csrc/convection3d.cu``), one column a thread (VX = 1: the extended
#: rows are often odd and start unaligned): the plan's in float32, then in
#: float64, where four rows a thread take 238 registers and one row 109
#: (32 x 8 with one row a thread was 5-10% faster than 32 x 16 with four
#: at the sphere's shapes and 256^3, scripts/bench_torch_stencil.py)
CONVECTION_TILES = ((32, 16, 4, 1), (32, 8, 1, 1))


def convection_union(ext_shapes) -> tuple:
    """The box K3's grid covers: the largest extent of the three
    components' shapes (each extended shape minus 2) on each axis."""
    return tuple(max(s[ax] - 2 for s in ext_shapes) for ax in range(3))


def convection_shape_error(ext_shapes):
    """Why K3 does not take extended arrays of ``ext_shapes`` (three (z, y,
    x) extents), or None: each has an interior and fewer than 2^31
    values, the union box fewer than 2^31 cells, and every array is large
    enough for the cells of each other component that read it (component
    c reads ext d at offsets -1 and 0 along d, 0 and +1 along c)."""
    if len(ext_shapes) != 3 or any(len(s) != 3 for s in ext_shapes):
        return "not three 3D extended arrays"
    if any(min(s) < 3 for s in ext_shapes):
        return "an extended array with no interior"
    if any(math.prod(s) >= 2 ** 31 for s in ext_shapes):
        return "an extended array of 2^31 values or more (32-bit offsets)"
    if math.prod(convection_union(ext_shapes)) >= 2 ** 31:
        return "a union box of 2^31 cells or more (32-bit offsets)"
    for c in range(3):
        shape = [s - 2 for s in ext_shapes[c]]
        for d in range(3):
            need = [s + 1 for s in shape]
            need[2 - c] += 1
            if d != c and any(e < n for e, n in zip(ext_shapes[d], need)):
                return (f"extended array {d} of shape "
                        f"{tuple(ext_shapes[d])} is too small for component "
                        f"{c} of shape {tuple(shape)}")
    return None


def convection_launch_plan(ext_shapes, dtype, slots) -> Plan:
    """K3's plan for extended arrays of ``ext_shapes`` and ``dtype``: the
    dtype's tile of ``CONVECTION_TILES`` with ``plan_for_tile``'s chunks
    of the union box for ``slots(tile)`` blocks held at once
    (``convection_resident_blocks``)."""
    tile = CONVECTION_TILES[dtype == torch.float64]
    return plan_for_tile(convection_union(ext_shapes), tile, slots(tile))


def convection_plan_error(ext_shapes, plan: Plan):
    """Why K3's C entry refuses ``plan`` for extended arrays of
    ``ext_shapes`` (it returns cudaErrorInvalidValue and the wrapper
    raises), or None when it takes it: the checks of ``launch`` and
    ``launch_tile`` in ``csrc/convection3d.cu``."""
    why = convection_shape_error(ext_shapes)
    if why:
        return why
    nz = convection_union(ext_shapes)[0]
    if plan.kz < 1 or _ceil(nz, plan.kz) > MAX_CHUNKS:
        return f"chunks of no plane, or more than {MAX_CHUNKS} of them"
    if tuple(plan[:4]) not in CONVECTION_TILES:
        return f"no instance of the tile {tuple(plan[:4])}"
    return None


def _check_k3(ext, inv_dl) -> None:
    """Raises unless K3 takes ``ext`` and ``inv_dl``: three 3D arrays of
    one float dtype on one device that ``convection_shape_error`` passes,
    and each component's three 1/dl vectors of its x, y and z extents."""
    if len(ext) != 3 or any(e.ndim != 3 for e in ext):
        raise ValueError("K3 takes three 3D extended velocity arrays")
    check_dtype("K3", ext[0])
    for e in ext:
        if e.device != ext[0].device or e.dtype != ext[0].dtype:
            raise ValueError("K3's extended arrays must share device and "
                             "dtype")
    why = convection_shape_error([tuple(e.shape) for e in ext])
    if why:
        raise ValueError(f"K3 does not take these arrays: {why}")
    shapes = [tuple(s - 2 for s in e.shape) for e in ext]
    if len(inv_dl) != 3 or any(not isinstance(iv, (tuple, list))
                               or len(iv) != 3 for iv in inv_dl):
        raise ValueError("K3 takes three 1/dl vectors per component")
    for c in range(3):
        check_vectors("K3", ext[0], inv_dl[c])
        if tuple(v.shape[0] for v in inv_dl[c]) != shapes[c][::-1]:
            raise ValueError(f"K3's inv_dl vectors of component {c} must "
                             "match its x, y and z extents")


def convection_resident_blocks(device, dtype, tile) -> int:
    """The blocks of K3's instance of ``tile`` (``dtype``) that ``device``
    holds at once (``_resident``)."""
    return _resident("convection3d", "convection3d_resident", device, dtype,
                     (), tile)


def convection_plan_on_card(ext) -> Plan:
    """The plan ``convection3d_apply`` launches for the CUDA arrays
    ``ext``."""
    return convection_launch_plan(
        [tuple(e.shape) for e in ext], ext[0].dtype,
        lambda tile: convection_resident_blocks(ext[0].device, ext[0].dtype,
                                                tile))


def convection_launch(ext, inv_dl, plan: Plan) -> tuple:
    """One launch of K3 with ``plan`` on CUDA tensors that
    ``convection3d_apply`` has checked: (N_u, N_v, N_w); counts nothing
    (the wrapper does).  Raises when the C entry refuses the plan, naming
    ``convection_plan_error``'s reason."""
    e0 = ext[0]
    fn = c_function("convection3d", "convection3d", e0.dtype,
                    [ctypes.c_void_p] * 3
                    + [ctypes.POINTER(ctypes.c_longlong)]
                    + [ctypes.c_void_p] * 3
                    + [ctypes.POINTER(ctypes.c_void_p)]
                    + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    out = tuple(torch.empty(tuple(s - 2 for s in e.shape), dtype=e0.dtype,
                            device=e0.device) for e in ext)
    ext_shape = (ctypes.c_longlong * 9)(*(n for e in ext for n in e.shape))
    iv = (ctypes.c_void_p * 9)(*(ptr(v) for vs in inv_dl for v in vs))
    with torch.cuda.device(e0.device):
        err = fn(*(ptr(e) for e in ext), ext_shape, *(ptr(o) for o in out),
                 iv, *plan, stream(e0.device))
    if err != 0:
        why = convection_plan_error([tuple(e.shape) for e in ext], plan)
        raise RuntimeError(f"K3 launch failed with CUDA error {err}"
                           + (f": {why}" if why else ""))
    return out


def convection3d_apply(ext, inv_dl) -> tuple:
    """K3: (N_u, N_v, N_w) from the three ghost-extended velocity arrays
    ``ext`` (each its component's shape plus 2 on every axis) and each
    component's ``inv_dl[c]`` = (1/dx, 1/dy, 1/dz) as 1D tensors.

    CUDA arrays launch the kernel once on the current stream with
    ``convection_plan_on_card``'s plan (one more in
    ``convection3d_apply.launches``); CPU arrays run the plain twin per
    component.  Raises on what the kernel does not take and when the
    launch reports an error."""
    _check_k3(ext, inv_dl)
    if ext[0].device.type == "cpu":
        return tuple(convection3d_apply_ref(ext, c, inv_dl[c])
                     for c in range(3))
    for e in ext:
        check_launchable("K3", e)
    out = convection_launch(ext, inv_dl, convection_plan_on_card(ext))
    count_launch(convection3d_apply)
    return out


convection3d_apply.launches = 0


def make_cuda_convection(mesh, bcset, *, dtype: torch.dtype, device):
    """K3: ``convection(q, bcstate)`` matching ``make_convection`` in 3D
    (None in 2D).  ``BoundarySet.extend`` fills the ghosts outside the
    kernel, as in the JAX package; then one K3 launch forms the three
    components.  The closure carries ``inv_dl`` (per component)."""
    if mesh.dim != 3:
        return None
    inv_dl = [tuple(torch.as_tensor(1.0 / np.asarray(mesh.dl(Field(c), d),
                                                     np.float64),
                                    dtype=dtype, device=device)
                    for d in range(3)) for c in range(3)]

    def convection(q: dict, bcstate: dict) -> dict:
        ext = [bcset.extend(q[VEL_NAMES[e]], e, bcstate) for e in range(3)]
        return dict(zip(VEL_NAMES, convection3d_apply(ext, inv_dl)))

    convection.inv_dl = inv_dl
    return convection
