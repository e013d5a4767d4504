"""K6/K7: the batched tridiagonal solve along one axis as a CUDA kernel.

Counterpart of ``petibm_tpu/linalg/pallas_pcr.py``: ``pcr_pallas`` (K6)
and ``pcr_pallas_blocked`` (K7) become one kernel,
``csrc/tridiag_pcr.cu``; the blocked variant and its VMEM sizing
(``fits_vmem``, ``pick_block``, ``device_vmem_budget``) have no use on the
card.  The multigrid smoother calls it on levels with a periodic axis
(``linalg/mg.py``).

``pcr`` launches the kernel on a CUDA tensor (one more in
``pcr.launches``) and runs the plain twin ``pcr_ref`` on a CPU tensor; it
never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from .._kernels import (c_function, check_dtype, check_launchable, ptr,
                        stream)
from .tridiag import tridiag_solve_pcr

#: the longest line the kernel takes (``pcr::kMaxLine`` in csrc/pcr.cuh)
MAX_LINE = 4096


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


def pcr(a, b, c, d, axis: int):
    """K6/K7: solve a[i] x[i-1] + b[i] x[i] + c[i] x[i+1] = d[i] along
    ``axis`` of 2D or 3D arrays of one shape (a[first] and c[last] are
    ignored).  Raises on shapes, dtypes or devices the kernel does not
    take, and when the launch reports an error."""
    for t in (b, c, d):
        if t.shape != a.shape or t.dtype != a.dtype or t.device != a.device:
            raise ValueError("K6/K7 takes a, b, c, d of one shape, dtype "
                             "and device")
    check_dtype("K6/K7", a)
    axis3 = check_lines("K6/K7", a.shape, axis)
    if a.device.type == "cpu":
        return pcr_ref(a, b, c, d, axis)
    for t in (a, b, c, d):
        check_launchable("K6/K7", t)
    fn = c_function("tridiag_pcr", "tridiag_pcr", a.dtype,
                    [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3
                    + [ctypes.c_int, ctypes.c_void_p])
    x = torch.empty_like(a)
    shape = (1,) * (3 - a.ndim) + tuple(a.shape)
    with torch.cuda.device(a.device):
        err = fn(ptr(a), ptr(b), ptr(c), ptr(d), ptr(x), *shape, axis3,
                 stream(a.device))
    if err != 0:
        raise RuntimeError(f"K6/K7 launch failed with CUDA error {err}")
    pcr.launches += 1
    return x


pcr.launches = 0
