"""Batched tridiagonal solve via parallel cyclic reduction (PCR).

Counterpart of ``petibm_tpu/linalg/tridiag.py``.  PCR eliminates the +-k
couplings of every line in ceil(log2(n)) vectorised passes.  The
multigrid smoother's line systems (finite-volume Poisson lines) are
strictly diagonally dominant, so PCR is stable in float32.

Solves a_i x_{i-1} + b_i x_i + c_i x_{i+1} = d_i along the LAST axis, any
leading batch axes; a[..., 0] and c[..., n-1] are ignored (set to 0).
This is the plain twin of the K6/K7 CUDA kernel (``cuda_pcr.py``).
"""

from __future__ import annotations

import math

import torch


def shift(arr: torch.Tensor, k: int, axis: int = -1,
          fill: float = 0.0) -> torch.Tensor:
    """arr shifted by +k along ``axis`` (value at index i becomes the old
    value at i-k; k may be negative), vacated entries filled with
    ``fill``."""
    n = arr.shape[axis]
    blk_shape = list(arr.shape)
    blk_shape[axis] = abs(k)
    blk = torch.full(blk_shape, fill, dtype=arr.dtype, device=arr.device)
    if k >= 0:
        return torch.cat([blk, arr.narrow(axis, 0, n - k)], dim=axis)
    return torch.cat([arr.narrow(axis, -k, n + k), blk], dim=axis)


def tridiag_solve_pcr(a, b, c, d):
    """Solve the batched tridiagonal systems (last axis) with PCR.

    After m passes row i couples only to rows i +- 2^m, with a_i = 0 for
    i < 2^m and c_i = 0 for i >= n - 2^m, so after ceil(log2(n)) passes
    every equation is diagonal: x_i = d_i / b_i.  Out-of-range neighbour
    diagonals read as 1 so the elimination factors vanish cleanly."""
    n = a.shape[-1]
    if n == 1:
        return d / b
    a = a.clone()
    c = c.clone()
    # filled on the device: an assigned number is copied from the host
    a[..., 0].fill_(0.0)
    c[..., n - 1].fill_(0.0)
    k = 1
    for _ in range(math.ceil(math.log2(n))):
        alpha = -a / shift(b, k, fill=1.0)
        beta = -c / shift(b, -k, fill=1.0)
        a, b, c, d = (
            alpha * shift(a, k),
            b + alpha * shift(c, k) + beta * shift(a, -k),
            beta * shift(c, -k),
            d + alpha * shift(d, k) + beta * shift(d, -k),
        )
        k *= 2
    return d / b
