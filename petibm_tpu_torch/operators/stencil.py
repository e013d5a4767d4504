"""Gradient, divergence and Laplacian as stencil closures on tensors.

Counterpart of ``petibm_tpu/operators/stencil.py`` (stencil.py:40-186).
Reference math:
  - gradient (creategradient.cpp:36-135): per velocity component c,
    ``(G p)_c(i) = (p(i+1) - p(i)) / dL_c(i)`` along c;
  - divergence (createdivergence.cpp:103-246): per pressure cell, the sum
    over directions of ``area_d * (u_d(i) - u_d(i-1))``, ghost columns
    folded through the a0/a1 ghost relation;
  - Laplacian (createlaplacian.cpp:108-162): per velocity point, the sum
    over directions of ``(f(+1)-f)/(dpos*dlself) + (f(-1)-f)/(dneg*dlself)``.

Ghosts go through ``BoundarySet.extend``, so the homogeneous (a0-folded
matrix action) and inhomogeneous (+ a1 correction) variants share one
code path.

Decomposed (``parallel/dist.py``), the closures are built on the rank's
``LocalMesh`` and act on its blocks: ``extend`` fills the interior sides
from the halo, the gradient appends the block's upper halo, and the
Laplacian's a1 correction lands only on blocks that lie on its face.
"""

from __future__ import annotations

import numpy as np
import torch

from ..boundary import BoundarySet
from ..mesh import StaggeredMesh
from ..types import Field

VEL_NAMES = ("u", "v", "w")


def _tensor(arr, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(arr, np.float64), dtype=dtype,
                           device=device)


def make_gradient(mesh: StaggeredMesh, *, dtype: torch.dtype, device,
                  part=None):
    """p -> velocity-space gradient closure (entries ±1/dL); ``part``: the
    rank's ``Partition`` of a decomposed run."""
    inv_dl = [_tensor(mesh.bcast(Field(c), c, 1.0 / mesh.dl(Field(c), c)),
                      dtype, device) for c in range(mesh.dim)]

    def gradient(p: torch.Tensor) -> dict:
        out = {}
        for c in range(mesh.dim):
            axis = mesh.axis_of(c)
            n = p.shape[axis]
            if part is not None and part.parts[c] > 1:
                # the next cell past the block: the neighbour's, or the
                # periodic image; none past the wall
                ext = part.extend_hi(p, c)
                m = mesh.n(Field(c), c)
                diff = ext.narrow(axis, 1, m) - ext.narrow(axis, 0, m)
            elif mesh.periodic[c]:
                # the appended max-face point wraps to p(0)
                hi = torch.cat([p.narrow(axis, 1, n - 1),
                                p.narrow(axis, 0, 1)], dim=axis)
                diff = hi - p
            else:
                diff = p.narrow(axis, 1, n - 1) - p.narrow(axis, 0, n - 1)
            out[VEL_NAMES[c]] = diff * inv_dl[c]
        return out

    return gradient


def make_flux_area_arrays(mesh: StaggeredMesh, *, dtype: torch.dtype,
                          device) -> list:
    """Face areas per direction, broadcast over the pressure shape: the
    product of the pressure cell widths in the other directions."""
    areas = []
    for c in range(mesh.dim):
        area = np.ones([1] * mesh.dim)
        for d in range(mesh.dim):
            if d == c:
                continue
            area = area * mesh.bcast(Field.P, d, mesh.dl(Field.P, d))
        areas.append(_tensor(area, dtype, device))
    return areas


def make_divergence(mesh: StaggeredMesh, bcset: BoundarySet, *,
                    dtype: torch.dtype, device):
    """velocity -> pressure-space divergence closure.

    ``divergence(q, bcstate)`` is the reference's ``D + DCorrection``;
    ``divergence(q, None, homogeneous=True)`` is bare ``D``."""
    areas = make_flux_area_arrays(mesh, dtype=dtype, device=device)

    def divergence(q: dict, bcstate, homogeneous: bool = False):
        out = None
        for c in range(mesh.dim):
            axis = mesh.axis_of(c)
            ext = bcset.extend(q[VEL_NAMES[c]], c, bcstate,
                               homogeneous=homogeneous, dirs=(c,))
            n = mesh.n(Field.P, c)
            # cell i faces: positive = u(i) -> ext index i+1,
            # negative = u(i-1) -> ext index i
            flux = ext.narrow(axis, 1, n) - ext.narrow(axis, 0, n)
            term = flux * areas[c]
            out = term if out is None else out + term
        return out

    return divergence


def make_laplacian(mesh: StaggeredMesh, bcset: BoundarySet, *,
                   dtype: torch.dtype, device):
    """velocity -> velocity Laplacian closure.

    ``laplacian(q, bcstate)`` is the reference's ``L + LCorrection``;
    ``homogeneous=True`` is bare ``L`` (a0 folded, a1 dropped).
    ``laplacian.correction(bcstate)`` is the a1 part alone."""
    cneg = {}
    cpos = {}
    for c in range(mesh.dim):
        cneg[c] = []
        cpos[c] = []
        for d in range(mesh.dim):
            line = mesh.lines[Field(c)][d]
            dself = line.interior_dl
            cneg[c].append(_tensor(mesh.bcast(Field(c), d,
                                              1.0 / (line.dneg() * dself)),
                                   dtype, device))
            cpos[c].append(_tensor(mesh.bcast(Field(c), d,
                                              1.0 / (line.dpos() * dself)),
                                   dtype, device))

    def component(c, f, bcstate, homogeneous=False):
        out = None
        for d in range(mesh.dim):
            axis = mesh.axis_of(d)
            ext = bcset.extend(f, c, bcstate, homogeneous=homogeneous,
                               dirs=(d,))
            n = f.shape[axis]
            lo = ext.narrow(axis, 0, n)
            hi = ext.narrow(axis, 2, n)
            term = cneg[c][d] * (lo - f) + cpos[c][d] * (hi - f)
            out = term if out is None else out + term
        return out

    def laplacian(q: dict, bcstate, homogeneous: bool = False) -> dict:
        return {VEL_NAMES[c]: component(c, q[VEL_NAMES[c]], bcstate,
                                        homogeneous)
                for c in range(mesh.dim)}

    def correction(bcstate: dict) -> dict:
        """L(q, bc) - L(q, hom): ghosts obey a0*target + a1 with a1
        independent of q, so the correction is cedge * a1 on the
        boundary-adjacent layer of each non-periodic face (O(surface))."""
        out = {}
        for c in range(mesh.dim):
            shape = mesh.shape(Field(c))
            corr = torch.zeros(shape, dtype=dtype, device=device)
            for d in range(mesh.dim):
                if mesh.periodic[d]:
                    continue
                axis = mesh.axis_of(d)
                for side, cvecs in ((0, cneg), (1, cpos)):
                    if not bcset.touches(d, side):
                        continue
                    a1 = bcstate[bcset.specs[(c, 2 * d + side)].key]["a1"]
                    cvec = cvecs[c][d]
                    cedge = cvec.narrow(axis, 0 if side == 0
                                        else cvec.shape[axis] - 1, 1)
                    layer = corr.narrow(axis, 0 if side == 0
                                        else shape[axis] - 1, 1)
                    layer += cedge * a1.unsqueeze(axis).to(dtype)
            out[VEL_NAMES[c]] = corr
        return out

    laplacian.correction = correction
    return laplacian
