"""Exact diagonal extraction for matrix-free stencil operators.

Counterpart of ``petibm_tpu/linalg/probe_diag.py``.  For a stencil of
radius r, points whose coordinates agree modulo a per-axis period p > r
never interact through that axis, so probing A with the lattice-colouring
indicator vectors recovers the exact diagonal:
``diag = sum_colours e_c * A(e_c)``.  On a periodic axis the period grows
until ``n % p == 0`` or ``n % p > r``, so no two same-colour indices
interact through the wrap either.  It runs once at setup (the Jacobi
preconditioner of the Krylov solves).

On a decomposed block the colours come from the global index (the
block's ``origin`` added) and the periods from the global extent, so two
points that meet across a block boundary never share a colour and every
rank probes with the same number of colours.
"""

from __future__ import annotations

import numpy as np
import torch


def _axis_period(n: int, radius: int) -> int:
    p = radius + 1
    while p < n and not (n % p == 0 or n % p > radius):
        p += 1
    return min(p, n)


def _color_masks(like: torch.Tensor, radius: int, origin=None,
                 global_shape=None) -> list:
    shape = tuple(like.shape)
    origin = origin or (0,) * len(shape)
    periods = [_axis_period(s, radius) for s in (global_shape or shape)]
    grids = np.meshgrid(*[(o + np.arange(s)) % p
                          for s, o, p in zip(shape, origin, periods)],
                        indexing="ij")
    masks = []
    for combo in np.ndindex(*periods):
        m = np.ones(shape, dtype=bool)
        for g, c in zip(grids, combo):
            m &= g == c
        masks.append(torch.as_tensor(m, device=like.device).to(like.dtype))
    return masks


def extract_diagonal(A, template, radius: int = 1, origin=None,
                     global_shape=None):
    """diag(A) for a stencil operator on a tensor or a dict of tensors.

    ``template`` has the operator's input shapes, dtype and device;
    ``radius`` is the stencil radius.  Each leaf (sorted keys, the JAX
    pytree order) is probed separately: coupling between leaves only
    reaches off-diagonal blocks.  On a decomposed block, ``origin`` is
    its first point's global index per axis and ``global_shape`` the
    global shape (a dict of them for a dict template)."""
    if not isinstance(template, dict):
        acc = torch.zeros_like(template)
        for m in _color_masks(template, radius, origin, global_shape):
            acc = acc + m * A(m)
        return acc
    diags = {}
    for key in sorted(template):
        acc = torch.zeros_like(template[key])
        gshape = None if global_shape is None else global_shape[key]
        for m in _color_masks(template[key], radius, origin, gshape):
            probe = {k: torch.zeros_like(v) for k, v in template.items()}
            probe[key] = m
            acc = acc + m * A(probe)[key]
        diags[key] = acc
    return {k: diags[k] for k in template}
