"""Diagonal operators R, R^-1, M-hat and M as per-component tensors.

Counterpart of ``petibm_tpu/operators/diag.py`` (reference:
src/operators/creatediagmatrix.cpp:43-234): R holds the flux areas at the
velocity points (the product of the velocity grid's cell widths in the
perpendicular directions), M-hat the cell width along the component's
own direction, M = M-hat * R^-1.  Each is a dict of dense arrays of the
velocity components' shapes, applied by elementwise multiplication.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh import StaggeredMesh
from ..types import Field

VEL_NAMES = ("u", "v", "w")


def _dense(mesh: StaggeredMesh, c: int, arr, dtype, device) -> torch.Tensor:
    """A host float64 factor broadcast to component ``c``'s shape."""
    return torch.as_tensor(np.broadcast_to(arr, mesh.shape(Field(c))).copy(),
                           dtype=dtype, device=device)


def make_r(mesh: StaggeredMesh, *, dtype: torch.dtype, device) -> dict:
    """Flux areas per velocity point (reference: createR, :90-117)."""
    out = {}
    for c in range(mesh.dim):
        area = np.ones([1] * mesh.dim)
        for d in range(mesh.dim):
            if d != c:
                area = area * mesh.bcast(Field(c), d, mesh.dl(Field(c), d))
        out[VEL_NAMES[c]] = _dense(mesh, c, area, dtype, device)
    return out


def make_rinv(mesh: StaggeredMesh, *, dtype: torch.dtype, device) -> dict:
    return {k: 1.0 / v
            for k, v in make_r(mesh, dtype=dtype, device=device).items()}


def make_mhat(mesh: StaggeredMesh, *, dtype: torch.dtype, device) -> dict:
    """Cell width along the component's own direction (reference:
    createMHead, :150-177)."""
    return {VEL_NAMES[c]: _dense(mesh, c, mesh.bcast(
        Field(c), c, mesh.dl(Field(c), c)), dtype, device)
        for c in range(mesh.dim)}


def make_m(mesh: StaggeredMesh, *, dtype: torch.dtype, device) -> dict:
    """M = M-hat * R^-1 (reference: createM, :180-207)."""
    rinv = make_rinv(mesh, dtype=dtype, device=device)
    mhat = make_mhat(mesh, dtype=dtype, device=device)
    return {k: mhat[k] * rinv[k] for k in rinv}
