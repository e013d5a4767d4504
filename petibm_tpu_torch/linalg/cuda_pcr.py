"""K6/K7: the batched tridiagonal solve along one axis as a CUDA kernel.

Counterpart of ``petibm_tpu/linalg/pallas_pcr.py``: ``pcr_pallas`` (K6)
and ``pcr_pallas_blocked`` (K7) become one entry point,
``csrc/tridiag_pcr.cu``; the blocked variant and its VMEM sizing
(``fits_vmem``, ``pick_block``, ``device_vmem_budget``) have no use on the
card.  The multigrid smoother calls it on levels with a periodic axis
(``linalg/mg.py``).

``launch_plan`` picks the kernel's path for a shape: lines of up to
``WARP_LINE`` rows are solved one a warp in registers, longer ones (up to
``MAX_LINE``) one or more a block in shared memory.  ``pcr`` launches the
kernel on a CUDA tensor (one more in ``pcr.launches``) and runs the plain
twin ``pcr_ref`` on a CPU tensor; it never falls back from one to the
other.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .._kernels import (c_function, check_dtype, check_launchable, ptr,
                        stream)
from .tridiag import tridiag_solve_pcr

#: the longest line the kernel takes (``pcr::kMaxLine`` in csrc/pcr.cuh)
MAX_LINE = 4096
#: rows a lane holds at most on the register paths (``kMaxRows``), and
#: the longest line they take (``kWarpLine``)
MAX_ROWS_PER_LANE = 8
WARP_LINE = 32 * MAX_ROWS_PER_LANE
#: lines (one warp each) of a ``warp_rows`` block (``kRowsWarps``) and
#: of a ``warp_tiles`` block (``kTileLines``)
ROWS_WARPS = 8
TILE_LINES = 8
#: the kernel's path codes (``Path`` in csrc/tridiag_pcr.cu)
PATHS = {"block": 0, "warp_rows": 1, "warp_tiles": 2}


class Plan(NamedTuple):
    """How the kernel solves one shape: ``path`` (a key of ``PATHS``),
    ``rows`` (rows a lane holds, 0 on the block path) and ``lines`` (lines
    a block)."""
    path: str
    rows: int
    lines: int


def launch_plan(shape, axis: int) -> Plan:
    """The plan for lines along ``axis`` of the 3D ``shape`` (a 2D array
    is (1, n1, n2)):

    - lines of at most ``WARP_LINE`` rows in an array of fewer than 2^31
      values: one warp a line, ``rows`` the least power of two with
      32 * rows >= n; along the contiguous axis ``warp_rows``
      (``ROWS_WARPS`` lines a block), along the others ``warp_tiles``
      (``TILE_LINES`` lines next to each other a block);
    - longer lines, up to ``MAX_LINE``: ``block_plan``."""
    n = shape[axis]
    if n > MAX_LINE:
        raise ValueError(f"K6/K7 takes lines of at most {MAX_LINE} rows, "
                         f"got {n}")
    if n > WARP_LINE or shape[0] * shape[1] * shape[2] >= 2 ** 31:
        return block_plan(shape, axis)
    rows = 1
    while 32 * rows < n:
        rows *= 2
    if axis == 2:
        return Plan("warp_rows", rows, ROWS_WARPS)
    return Plan("warp_tiles", rows, TILE_LINES)


def block_plan(shape, axis: int) -> Plan:
    """The block path for lines along ``axis`` of the 3D ``shape``: as
    many whole lines a block as fit 2048 values, at most 64 and at most
    the batch (``pcr::make_lines``).  It takes any line of up to
    ``MAX_LINE`` rows."""
    n = shape[axis]
    nlines = shape[0] * shape[1] * shape[2] // n
    return Plan("block", 0, min(max(2048 // n, 1), 64, nlines))


def pcr_ref(a, b, c, d, axis: int):
    """Plain twin of K6/K7: ``tridiag_solve_pcr`` with the line axis moved
    last and back."""
    def last(t):
        return torch.movedim(t, axis, -1)

    x = tridiag_solve_pcr(last(a), last(b), last(c), last(d))
    return torch.movedim(x, -1, axis)


def check_lines(name: str, shape, axis: int) -> int:
    """The line axis of a 2D or 3D ``shape`` as an axis of the kernels'
    3D view (2D arrays are (1, n1, n2)); raises on what they do not
    take."""
    ndim = len(shape)
    if ndim not in (2, 3):
        raise ValueError(f"{name} takes 2D or 3D arrays, got shape "
                         f"{tuple(shape)}")
    if not -ndim <= axis < ndim:
        raise ValueError(f"{name}: axis {axis} out of range for {ndim}D")
    axis %= ndim
    if shape[axis] > MAX_LINE:
        raise ValueError(f"{name} takes lines of at most {MAX_LINE} rows, "
                         f"got {shape[axis]}")
    if min(shape) < 1:
        raise ValueError(f"{name} takes non-empty arrays")
    return axis + 3 - ndim


def launch(a, b, c, d, axis3: int, plan: Plan):
    """One launch of the kernel with ``plan`` on CUDA tensors that ``pcr``
    has checked; counts nothing (``pcr`` does)."""
    fn = c_function("tridiag_pcr", "tridiag_pcr", a.dtype,
                    [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3
                    + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    x = torch.empty_like(a)
    shape = (1,) * (3 - a.ndim) + tuple(a.shape)
    with torch.cuda.device(a.device):
        err = fn(ptr(a), ptr(b), ptr(c), ptr(d), ptr(x), *shape, axis3,
                 PATHS[plan.path], plan.rows, plan.lines, stream(a.device))
    if err != 0:
        raise RuntimeError(f"K6/K7 launch failed with CUDA error {err}")
    return x


def pcr(a, b, c, d, axis: int):
    """K6/K7: solve a[i] x[i-1] + b[i] x[i] + c[i] x[i+1] = d[i] along
    ``axis`` of 2D or 3D arrays of one shape (a[first] and c[last] are
    ignored).  Raises on shapes, dtypes or devices the kernel does not
    take, and when the launch reports an error."""
    for t in (b, c, d):
        if t.shape != a.shape or t.dtype != a.dtype or t.device != a.device:
            raise ValueError("K6/K7 takes a, b, c, d of one shape, dtype "
                             "and device")
    check_dtype("K6/K7", a, bf16=True)
    axis3 = check_lines("K6/K7", a.shape, axis)
    if a.device.type == "cpu":
        return pcr_ref(a, b, c, d, axis)
    for t in (a, b, c, d):
        check_launchable("K6/K7", t)
    shape = (1,) * (3 - a.ndim) + tuple(a.shape)
    x = launch(a, b, c, d, axis3, launch_plan(shape, axis3))
    pcr.launches += 1
    return x


pcr.launches = 0
