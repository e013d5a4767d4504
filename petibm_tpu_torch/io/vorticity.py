"""Vorticity post-processing on tensors.

Counterpart of ``petibm_tpu/io/vorticity.py`` (reference:
applications/vorticity/main.cpp:185-378): finite differences of the
ghost-extended velocity on vertex-aligned grids; 2D: wz at (x-vertex,
y-vertex); 3D: wx at (x-center, y-vertex, z-vertex), wy and wz by cyclic
analogy.  The index offsets follow the reference loops literally
(including the x-shift of the 3D wx/wy center-aligned samples,
main.cpp:302-338).  The fields stay on their device.
"""

from __future__ import annotations

import torch

from ..boundary import BoundarySet
from ..mesh import StaggeredMesh
from ..types import Field


def _gdiff(mesh: StaggeredMesh, field: Field, d: int, n: int,
           like: torch.Tensor) -> torch.Tensor:
    """The first n adjacent differences of the ghosted coordinate line
    (entry i is coord[i] - coord[i-1] in reference indexing), as a tensor
    like ``like``."""
    g = mesh.coord_ghosted(field, d)
    return torch.as_tensor((g[1:] - g[:-1])[:n], dtype=like.dtype,
                           device=like.device)


def vorticity_meshes(mesh: StaggeredMesh) -> dict:
    """Vorticity grid coordinates keyed by name, numpy float64
    (reference: initVorticityMesh, main.cpp:380-494)."""
    V, P = Field.VERTEX, Field.P
    if mesh.dim == 2:
        return {"wz": [mesh.coord(V, 0), mesh.coord(V, 1)]}
    return {
        "wx": [mesh.coord(P, 0), mesh.coord(V, 1), mesh.coord(V, 2)],
        "wy": [mesh.coord(V, 0), mesh.coord(P, 1), mesh.coord(V, 2)],
        "wz": [mesh.coord(V, 0), mesh.coord(V, 1), mesh.coord(P, 2)],
    }


def compute_vorticity(mesh: StaggeredMesh, bcset: BoundarySet, q: dict,
                      bcstate: dict) -> dict:
    """Vorticity from the ghost-extended velocity: tensors in (z, y, x)
    layout on the velocity's device, keyed wz (2D) or wx, wy, wz (3D)."""
    ext = [bcset.extend(q[("u", "v", "w")[c]], c, bcstate)
           for c in range(mesh.dim)]
    U, Vf, P, Vx = Field.U, Field.V, Field.P, Field.VERTEX
    like = ext[0]

    if mesh.dim == 2:
        u, v = ext
        n4x, n4y = mesh.n(Vx, 0), mesh.n(Vx, 1)
        dxv = _gdiff(mesh, Vf, 0, n4x, like)
        dyu = _gdiff(mesh, U, 1, n4y, like)
        # wz[j,i] = (v[j-1][i]-v[j-1][i-1])/dxv - (u[j][i-1]-u[j-1][i-1])/dyu
        # (main.cpp:231-243); the extended arrays are shifted by +1
        wz = ((v[0:n4y, 1:n4x + 1] - v[0:n4y, 0:n4x]) / dxv[None, :]
              - (u[1:n4y + 1, 0:n4x] - u[0:n4y, 0:n4x]) / dyu[:, None])
        return {"wz": wz}

    u, v, w = ext
    n3 = [mesh.n(P, d) for d in range(3)]
    n4 = [mesh.n(Vx, d) for d in range(3)]
    out = {}
    # wx (n4z, n4y, n3x): (w[k-1][j][i-1]-w[k-1][j-1][i-1])/dy_w
    #                   - (v[k][j-1][i-1]-v[k-1][j-1][i-1])/dz_v  (:302-318)
    dyw = _gdiff(mesh, Field.W, 1, n4[1], like)
    dzv = _gdiff(mesh, Vf, 2, n4[2], like)
    out["wx"] = ((w[0:n4[2], 1:n4[1] + 1, 0:n3[0]]
                  - w[0:n4[2], 0:n4[1], 0:n3[0]]) / dyw[None, :, None]
                 - (v[1:n4[2] + 1, 0:n4[1], 0:n3[0]]
                    - v[0:n4[2], 0:n4[1], 0:n3[0]]) / dzv[:, None, None])
    # wy (n4z, n3y, n4x): (u[k][j-1][i-1]-u[k-1][j-1][i-1])/dz_u
    #                   - (w[k-1][j-1][i]-w[k-1][j-1][i-1])/dx_w  (:322-338)
    dzu = _gdiff(mesh, U, 2, n4[2], like)
    dxw = _gdiff(mesh, Field.W, 0, n4[0], like)
    out["wy"] = ((u[1:n4[2] + 1, 0:n3[1], 0:n4[0]]
                  - u[0:n4[2], 0:n3[1], 0:n4[0]]) / dzu[:, None, None]
                 - (w[0:n4[2], 0:n3[1], 1:n4[0] + 1]
                    - w[0:n4[2], 0:n3[1], 0:n4[0]]) / dxw[None, None, :])
    # wz (n3z, n4y, n4x): (v[k][j-1][i]-v[k][j-1][i-1])/dx_v
    #                   - (u[k][j][i-1]-u[k][j-1][i-1])/dy_u  (:340-357)
    dxv = _gdiff(mesh, Vf, 0, n4[0], like)
    dyu = _gdiff(mesh, U, 1, n4[1], like)
    out["wz"] = ((v[1:n3[2] + 1, 0:n4[1], 1:n4[0] + 1]
                  - v[1:n3[2] + 1, 0:n4[1], 0:n4[0]]) / dxv[None, None, :]
                 - (u[1:n3[2] + 1, 1:n4[1] + 1, 0:n4[0]]
                    - u[1:n3[2] + 1, 0:n4[1], 0:n4[0]]) / dyu[None, :, None])
    return out
