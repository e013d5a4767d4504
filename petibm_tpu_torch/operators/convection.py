"""Divergence-form convection N(u) as a stencil closure on tensors.

Counterpart of ``petibm_tpu/operators/convection.py`` (convection.py:28;
reference: createconvection.cpp:40-195).  For velocity component c,
``N_c = sum_d d/dx_d (adv_d * face_c)`` with 2-point face averages; for
``d == c`` the term is ``(uE^2 - uW^2)/dL``.  Each component is extended
once, inhomogeneously (the convection term sees the true ghost values).
"""

from __future__ import annotations

import numpy as np
import torch

from ..boundary import BoundarySet
from ..mesh import StaggeredMesh
from ..types import Field

VEL_NAMES = ("u", "v", "w")


def make_convection(mesh: StaggeredMesh, bcset: BoundarySet, *,
                    dtype: torch.dtype, device):
    inv_dl = {c: [torch.as_tensor(
        np.asarray(mesh.bcast(Field(c), d, 1.0 / mesh.dl(Field(c), d)),
                   np.float64), dtype=dtype, device=device)
        for d in range(mesh.dim)] for c in range(mesh.dim)}

    def window(ext, out_shape, offsets):
        """A window of ``out_shape`` from an extended array; ``offsets``
        are per-direction shifts in grid-index space (array axes are
        reversed)."""
        idx = []
        for ax in range(ext.ndim):
            off = offsets.get(mesh.dim - 1 - ax, 0)
            idx.append(slice(1 + off, 1 + off + out_shape[ax]))
        return ext[tuple(idx)]

    def convection(q: dict, bcstate: dict) -> dict:
        ext = {c: bcset.extend(q[VEL_NAMES[c]], c, bcstate)
               for c in range(mesh.dim)}
        out = {}
        for c in range(mesh.dim):
            shape = q[VEL_NAMES[c]].shape
            total = None
            for d in range(mesh.dim):
                if d == c:
                    fW = 0.5 * (window(ext[c], shape, {d: -1})
                                + window(ext[c], shape, {d: 0}))
                    fE = 0.5 * (window(ext[c], shape, {d: 0})
                                + window(ext[c], shape, {d: 1}))
                    term = (fE * fE - fW * fW) * inv_dl[c][d]
                else:
                    aM = 0.5 * (window(ext[c], shape, {d: -1})
                                + window(ext[c], shape, {d: 0}))
                    aP = 0.5 * (window(ext[c], shape, {d: 0})
                                + window(ext[c], shape, {d: 1}))
                    advM = 0.5 * (window(ext[d], shape, {d: -1, c: 0})
                                  + window(ext[d], shape, {d: -1, c: 1}))
                    advP = 0.5 * (window(ext[d], shape, {d: 0, c: 0})
                                  + window(ext[d], shape, {d: 0, c: 1}))
                    term = (advP * aP - advM * aM) * inv_dl[c][d]
                total = term if total is None else total + term
            out[VEL_NAMES[c]] = total
        return out

    return convection
