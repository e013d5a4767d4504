"""K4/K5: the multigrid smoother's fused line sweep as a CUDA kernel.

Counterpart of ``petibm_tpu/linalg/pallas_sweep.py``: ``fused_sweep``
(K4) and ``fused_sweep_blocked`` (K5) become one kernel,
``csrc/line_sweep.cu``, which builds every other axis's coupling itself,
so K5's precomputed right side and the VMEM sizing (``sweep_fits_vmem``,
``pick_sweep_block``) have no use on the card.

One damped line-Jacobi sweep along direction d of a non-periodic level
scales each line's system by the perpendicular area A_d = prod_{e != d}
w_e, which makes the sub/super-diagonals pure 1D vectors shared by every
line (pallas_sweep.py:12-24):

    a'[i] = -c_d[i],   c'[i] = -c_d[i+1],
    b'[batch, i] = a_d[i] + w_d[i] * sum_{e != d} (a_e / w_e)[batch],
    rhs'[batch, i] = rhs / A_d + sum_{e != d} (w_d[i] / w_e) * couple_e(phi),

solves them by PCR and returns phi + omega * (x - phi).  ``launch_plan``
picks the kernel's path for a shape: lines of up to ``WARP_LINE`` rows
are swept one a warp in registers, longer ones (up to ``MAX_LINE`` rows)
one or more a block in shared memory.  ``fused_sweep`` launches the kernel on
a CUDA tensor (one more in ``fused_sweep.launches``) and runs the plain
twin ``fused_sweep_ref`` on a CPU tensor; it never falls back from one to
the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._kernels import (c_function, check_dtype, check_launchable,
                        count_launch, ptr, stream)
from .cuda_pcr import MAX_LINE, PATHS, Plan, block_plan, check_lines, pcr_ref
from .tridiag import shift

#: rows a lane holds on the register paths (the kernel's instances), and
#: the longest line those paths take (``kMaxRows``).  R = 5 and 3 fill the
#: sphere's 160/130- and 80/65-row lines.  Longer lines take the block
#: path: R = 8 was slower than R = 5 on the sphere's lines and than the
#: block path on the flagship's 225-row lines (scripts/bench_torch_sweep.py)
WARP_ROWS = (1, 2, 3, 4, 5)
WARP_LINE = 32 * 5
#: lines (one warp each) of a ``warp_rows`` block (``kRowsWarps``) and of
#: a ``warp_tiles`` block: ``TILE_LINES``, or ``WIDE_TILE_LINES`` in
#: batches of at least ``WIDE_TILES`` lines (16 beat 8 at the sphere's
#: finest level, 20800 lines, and lost at its level 1, 5200)
ROWS_WARPS = 8
TILE_LINES = 8
WIDE_TILE_LINES = 16
WIDE_TILES = 16384


def launch_plan(shape, axis: int) -> Plan:
    """The plan for sweeping lines along ``axis`` of the 3D ``shape`` (a
    2D level is (1, n1, n2)):

    - lines of at most ``WARP_LINE`` rows in an array of fewer than 2^31
      values: one warp a line, ``rows`` the least of
      ``WARP_ROWS`` with 32 * rows >= n; along the contiguous axis
      ``warp_rows`` (``ROWS_WARPS`` lines a block), along the others
      ``warp_tiles`` (``TILE_LINES`` lines next to each other a block, or
      ``WIDE_TILE_LINES`` in batches of at least ``WIDE_TILES`` lines);
    - other lines, up to ``MAX_LINE``: ``block_plan``."""
    n = shape[axis]
    if n > MAX_LINE:
        raise ValueError(f"K4/K5 takes lines of at most {MAX_LINE} rows, "
                         f"got {n}")
    size = shape[0] * shape[1] * shape[2]
    if n > WARP_LINE or size >= 2 ** 31:
        return block_plan(shape, axis)
    rows = min(r for r in WARP_ROWS if 32 * r >= n)
    if axis == 2:
        return Plan("warp_rows", rows, ROWS_WARPS)
    return Plan("warp_tiles", rows, WIDE_TILE_LINES
                if size // n >= WIDE_TILES else TILE_LINES)


def sweep_aux(level, d: int, dtype: torch.dtype) -> list:
    """The sweep's small broadcast-shaped operands for direction ``d`` of
    a non-periodic ``Level``, as contiguous CPU tensors of ``dtype``
    (float32, float64 or bfloat16): computed in host float64 from the
    level's factors read as float64, and cast by torch at the end, which
    rounds float64 to bfloat16 through float32 as ml_dtypes does (a copy
    of pallas_sweep.py:65-115, whose numpy cast has bfloat16 from
    ml_dtypes; numpy alone has none):

    ``[a_lo, c_hi, diag_line, w_line, inv_area, s_batch]`` and, for each
    other direction e in ascending order (descending array axes),
    ``[c_lo_e, c_hi_e, inv_w_e]``:

    - ``a_lo``/``c_hi``: the shared sub/super-diagonals -c_d[i] / -c_d[i+1]
    - ``diag_line``: a_d = c_d[:-1] + c_d[1:]
    - ``w_line``: the line direction's cell widths
    - ``inv_area``: 1 / prod_{e != d} w_e (batch-shaped)
    - ``s_batch``: sum_{e != d} a_e / w_e (batch-shaped)
    - per other direction e: the coupling factors c_e[:-1], c_e[1:] and
      1 / w_e
    """
    ndim = len(level.shape)

    def host(vec):
        if isinstance(vec, torch.Tensor):
            vec = vec.detach().cpu().to(torch.float64).numpy()
        return np.asarray(vec, np.float64)

    def bcast(vec, direction):
        a = host(vec)
        return a.reshape(level.bshape(direction, len(a)))

    c_d = host(level.c1d[d])
    # wall entries of c1d are zero for non-periodic directions, so
    # a_lo[0] = c_hi[-1] = 0 as PCR requires
    a_lo = bcast(-c_d[:-1], d)
    c_hi = bcast(-c_d[1:], d)
    diag_line = bcast(c_d[:-1] + c_d[1:], d)
    w_line = bcast(level.w1d[d], d)

    inv_area = None
    s_batch = None
    extras = []
    for e in range(ndim):
        if e == d:
            continue
        w_e = host(level.w1d[e])
        c_e = host(level.c1d[e])
        inv_w = bcast(1.0 / w_e, e)
        inv_area = inv_w if inv_area is None else inv_area * inv_w
        a_e = bcast((c_e[:-1] + c_e[1:]) / w_e, e)
        s_batch = a_e if s_batch is None else s_batch + a_e
        extras += [bcast(c_e[:-1], e), bcast(c_e[1:], e), inv_w]
    return [torch.as_tensor(np.ascontiguousarray(a)).to(dtype) for a in
            [a_lo, c_hi, diag_line, w_line, inv_area, s_batch] + extras]


def _other_axes(ndim: int, line_axis: int) -> tuple:
    # sweep_aux emits per-direction extras in ascending direction order,
    # i.e. descending array axes (axis = ndim - 1 - direction)
    return tuple(ax for ax in reversed(range(ndim)) if ax != line_axis)


def fused_sweep_ref(phi, rhs, aux, line_axis: int, omega: float):
    """Plain twin of K4/K5: the algebra of the Pallas kernel body
    (``_make_sweep_kernel``, pallas_sweep.py:118-145) in its order of
    operations; ``aux`` is :func:`sweep_aux` as tensors on phi's device.
    On bfloat16 tensors each operation rounds to bfloat16, omega entering
    as a float32 scalar (the Pallas kernel rounds a weakly typed omega to
    bfloat16 first: the same for the solvers' omega = 1)."""
    ndim = phi.ndim
    line_axis %= ndim
    a_lo, c_hi, diag_line, w_line, inv_area, s_batch = aux[:6]
    b = rhs * inv_area
    for j, e_axis in enumerate(_other_axes(ndim, line_axis)):
        c_lo, c_hi_e, inv_w = aux[6 + 3 * j:9 + 3 * j]
        couple = (c_lo * shift(phi, 1, e_axis)
                  + c_hi_e * shift(phi, -1, e_axis))
        b = b + (w_line * inv_w) * couple
    diag = diag_line + w_line * s_batch
    # the PCR passes of the Pallas kernel (pallas_sweep.py:46-62) are the
    # twin solver's; a_lo[first] and c_hi[last] are already 0
    x = pcr_ref(a_lo.expand(phi.shape), diag, c_hi.expand(phi.shape), b,
                line_axis)
    return phi + omega * (x - phi)


def _check_sweep(phi, rhs, aux, line_axis: int) -> int:
    if rhs.shape != phi.shape or rhs.dtype != phi.dtype \
            or rhs.device != phi.device:
        raise ValueError("K4/K5 takes phi and rhs of one shape, dtype and "
                         "device")
    check_dtype("K4/K5", phi, bf16=True)
    axis3 = check_lines("K4/K5", phi.shape, line_axis)
    ndim = phi.ndim
    line_axis %= ndim
    if len(aux) != 6 + 3 * (ndim - 1):
        raise ValueError(f"K4/K5 takes {6 + 3 * (ndim - 1)} sweep_aux "
                         f"operands for a {ndim}D level, got {len(aux)}")
    nlines = phi.numel() // phi.shape[line_axis]
    want = [phi.shape[line_axis]] * 4 + [nlines] * 2
    for e_axis in _other_axes(ndim, line_axis):
        want += [phi.shape[e_axis]] * 3
    for t, size in zip(aux, want):
        if t.dtype != phi.dtype or t.device != phi.device:
            raise ValueError("K4/K5's sweep_aux operands must share phi's "
                             "dtype and device")
        if t.numel() != size or not t.is_contiguous():
            raise ValueError("K4/K5's sweep_aux operands do not match "
                             f"phi's shape {tuple(phi.shape)}")
    return axis3


def launch(phi, rhs, aux, line_axis: int, omega: float, plan: Plan):
    """One launch of the kernel with ``plan`` on CUDA tensors that
    ``fused_sweep`` has checked; counts nothing (``fused_sweep`` does)."""
    fn = c_function("line_sweep", "line_sweep", phi.dtype,
                    [ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_void_p)]
                    + [ctypes.c_longlong] * 3
                    + [ctypes.c_int, ctypes.c_double] + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])
    ndim = phi.ndim
    line_axis %= ndim
    vec = [None] * 15
    vec[:6] = aux[:6]
    for j, e_axis in enumerate(_other_axes(ndim, line_axis)):
        e3 = e_axis + 3 - ndim
        vec[6 + 3 * e3:9 + 3 * e3] = aux[6 + 3 * j:9 + 3 * j]
    pointers = (ctypes.c_void_p * 15)(*(ptr(t) for t in vec))
    out = torch.empty_like(phi)
    shape = (1,) * (3 - ndim) + tuple(phi.shape)
    with torch.cuda.device(phi.device):
        err = fn(ptr(phi), ptr(rhs), ptr(out), pointers, *shape,
                 line_axis + 3 - ndim, float(omega), PATHS[plan.path],
                 plan.rows, plan.lines, stream(phi.device))
    if err != 0:
        raise RuntimeError(f"K4/K5 launch failed with CUDA error {err}")
    return out


def fused_sweep(phi, rhs, aux, line_axis: int, omega: float):
    """K4/K5: one damped line-Jacobi sweep along ``line_axis`` of a 2D or
    3D non-periodic level; ``aux`` from :func:`sweep_aux` as tensors on
    phi's device.  Raises on shapes, dtypes or devices the kernel does not
    take, and when the launch reports an error."""
    axis3 = _check_sweep(phi, rhs, aux, line_axis)
    if phi.device.type == "cpu":
        return fused_sweep_ref(phi, rhs, aux, line_axis, omega)
    check_launchable("K4/K5", phi)
    check_launchable("K4/K5", rhs)
    shape = (1,) * (3 - phi.ndim) + tuple(phi.shape)
    out = launch(phi, rhs, aux, line_axis, omega,
                 launch_plan(shape, axis3))
    count_launch(fused_sweep)
    return out


fused_sweep.launches = 0
