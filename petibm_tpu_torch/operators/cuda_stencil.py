"""Hand-written CUDA kernels for the hot stencil operations.

Counterpart of ``petibm_tpu/operators/pallas_stencil.py``.  This slice
carries K1, the separable pressure Poisson apply (the residual operator of
the pressure refinement loop); the 3D kernels K2a, K2b and K3 come with
the 3D slice.

``poisson_apply_separable(phi, level)`` launches the kernel of
``csrc/poisson_separable.cu`` on a CUDA tensor and calls the plain PyTorch
twin ``poisson_apply_separable_ref`` on a CPU tensor; it never falls back
from one to the other on failure.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _kernels
from ..linalg.mg import Level

_KERNEL = "poisson_separable"
_C_FUNCS = {torch.float32: "poisson_apply_separable_f32",
            torch.float64: "poisson_apply_separable_f64"}


def _shift(phi: torch.Tensor, axis: int, step: int) -> torch.Tensor:
    """phi[i - step] along ``axis`` with zeros shifted in (step = +1 reads
    the lower neighbour, -1 the upper one)."""
    n = phi.shape[axis]
    zero = torch.zeros_like(phi.narrow(axis, 0, 1))
    if step > 0:
        return torch.cat([zero, phi.narrow(axis, 0, n - 1)], dim=axis)
    return torch.cat([phi.narrow(axis, 1, n - 1), zero], dim=axis)


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
        term = ((c_lo + c_hi) * phi - c_lo * _shift(phi, axis, 1)
                - c_hi * _shift(phi, axis, -1))
        term = area * term
        out = term if out is None else out + term
    return out


def _c_function(dtype: torch.dtype):
    """The C entry point for ``dtype`` with its ctypes signature set
    (pointers and the stream as c_void_p, so none is cut to 32 bits)."""
    fn = getattr(_kernels.library(_KERNEL), _C_FUNCS[dtype])
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 3
                       + [ctypes.c_int, ctypes.c_void_p])
    return fn


def _check(phi: torch.Tensor, level: Level) -> None:
    if phi.ndim not in (2, 3) or phi.ndim != len(level.shape):
        raise ValueError(f"K1 takes a 2D or 3D field matching the level, got "
                         f"shape {tuple(phi.shape)} for level {level.shape}")
    if tuple(phi.shape) != tuple(level.shape):
        raise ValueError(f"field shape {tuple(phi.shape)} != level shape "
                         f"{tuple(level.shape)}")
    if any(level.periodic):
        raise ValueError("K1 applies non-periodic grids only")
    if phi.dtype not in _C_FUNCS:
        raise TypeError(f"K1 takes float32 or float64, got {phi.dtype}")
    for vec in (*level.c1d, *level.w1d):
        if vec.device != phi.device or vec.dtype != phi.dtype:
            raise ValueError("K1 factors must share the field's device and "
                             f"dtype ({phi.device}, {phi.dtype})")
        if not vec.is_contiguous():
            raise ValueError("K1 factors must be contiguous")


def poisson_apply_separable(phi: torch.Tensor, level: Level) -> torch.Tensor:
    """K1: the separable apply of the negated Poisson operator -D B1 G.

    A CUDA ``phi`` launches the kernel on the current stream (one more in
    ``poisson_apply_separable.launches``); a CPU ``phi`` runs the plain
    twin.  Raises on shapes, dtypes or devices the kernel does not take,
    and when the launch reports an error."""
    _check(phi, level)
    if phi.device.type == "cpu":
        return poisson_apply_separable_ref(phi, level)
    if phi.device.type != "cuda":
        raise ValueError(f"K1 runs on cuda or cpu tensors, got {phi.device}")
    if not phi.is_contiguous():
        raise ValueError("K1 takes a contiguous field")
    fn = _c_function(phi.dtype)
    out = torch.empty_like(phi)
    shape = (1,) * (3 - phi.ndim) + tuple(phi.shape)
    c = list(level.c1d) + [None] * (3 - phi.ndim)
    w = list(level.w1d) + [None] * (3 - phi.ndim)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        err = fn(ptr(phi), ptr(out), ptr(c[0]), ptr(w[0]), ptr(c[1]),
                 ptr(w[1]), ptr(c[2]), ptr(w[2]), *shape, phi.ndim, stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed with CUDA error {err}")
    poisson_apply_separable.launches += 1
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
