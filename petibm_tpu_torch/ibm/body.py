"""Lagrangian bodies.

Reference (src/body/singlebodypoints.cpp, bodypack.cpp;
include/petibm/singlebody.h, bodypack.h): a body is a list of Lagrangian
points read from an ASCII file (count + coordinates); a pack concatenates
several bodies into one packed force vector.  The reference 1D-partitions
points over MPI ranks with replicated coordinates; here coordinates and
forces are dense (nPts, dim) arrays — small enough to replicate per device,
with spreading/interpolation doing the cross-shard work.

Copy of ``petibm_tpu/ibm/body.py`` (held equal to the original by
tests/test_torch_host.py).
"""

from __future__ import annotations

import os

import numpy as np

from ..mesh import StaggeredMesh
from ..types import Field


def read_lagrangian_points(path: str) -> np.ndarray:
    """ASCII body file: first line nPts, then one coordinate row per point
    (reference: io.cpp:23-128 readLagrangianPoints).  Parses through the
    native hostcore when available (large 3D bodies are 10^5-10^6 rows)."""
    from .. import native

    coords = native.read_lagrangian_points(path) if native.available() else None
    if coords is not None:
        return coords
    with open(path) as fh:
        first = fh.readline().split()
        if len(first) != 1:
            raise ValueError(f"first line of {path} must hold a single count")
        n = int(first[0])
        rows = []
        for line in fh:
            line = line.strip()
            if line:
                rows.append([float(v) for v in line.split()])
    coords = np.asarray(rows, dtype=np.float64)
    if coords.shape[0] != n:
        raise ValueError(
            f"{path}: expected {n} points, found {coords.shape[0]}")
    return coords


def write_lagrangian_points(path: str, coords: np.ndarray) -> None:
    """Body point file writer (reference: singlebodypoints.cpp:238-290
    writeBody; note writeBody omits the count line)."""
    from .. import native

    coords = np.ascontiguousarray(coords, dtype=np.float64)
    if native.available() and native.write_lagrangian_points(path, coords):
        return
    with open(path, "w") as fh:
        for row in np.asarray(coords):
            fh.write("\t".join(f"{v:10.8e}" for v in row) + "\n")


class SingleBody:
    """One rigid body (reference: singlebody.h:32-234)."""

    def __init__(self, name: str, coords: np.ndarray, dim: int):
        if coords.ndim != 2 or coords.shape[1] != dim:
            raise ValueError(
                f"body {name}: coords shape {coords.shape} != (nPts, {dim})")
        self.name = name
        self.coords0 = np.array(coords)  # reference coordinates (coords0)
        self.coords = np.array(coords)
        self.dim = dim

    @property
    def n_pts(self) -> int:
        return self.coords.shape[0]

    def mesh_idx(self, mesh: StaggeredMesh) -> np.ndarray:
        """Owning pressure-cell index per point per direction via binary
        search on the vertex gridlines (reference:
        singlebodypoints.cpp:95-120 updateMeshIdx)."""
        from .. import native

        out = np.empty((self.n_pts, self.dim), dtype=np.int32)
        for d in range(self.dim):
            verts = mesh.coord(Field.VERTEX, d)
            lo, hi = mesh.min[d], mesh.max[d]
            c = self.coords[:, d]
            if np.any((c <= lo) | (c >= hi)):
                raise ValueError(
                    f"body {self.name}: coordinate outside domain in "
                    f"direction {d}")
            idx = native.search_cells(verts, c) if native.available() else None
            if idx is None:
                idx = np.searchsorted(verts, c, side="right") - 1
            out[:, d] = idx
        return out


class BodyPack:
    """All immersed bodies of a simulation (reference: bodypack.h:70-260).

    The packed Lagrangian force vector is a single (nTotal, dim) array;
    per-body slices are static python ranges.
    """

    def __init__(self, config: dict, mesh: StaggeredMesh):
        self.mesh = mesh
        self.dim = mesh.dim
        self.bodies: list[SingleBody] = []
        directory = config.get("directory", os.getcwd())
        for i, node in enumerate(config.get("bodies", []) or []):
            btype = node.get("type", "points")
            if btype != "points":
                raise ValueError(f"unsupported body type: {btype}")
            path = node["file"]
            if not os.path.isabs(path):
                path = os.path.join(directory, path)
            name = node.get("name", f"body{i:02d}")
            coords = read_lagrangian_points(path)
            self.bodies.append(SingleBody(name, coords[:, :self.dim], self.dim))

    @property
    def n_bodies(self) -> int:
        return len(self.bodies)

    @property
    def n_pts(self) -> int:
        return sum(b.n_pts for b in self.bodies)

    def slices(self) -> list[slice]:
        out, off = [], 0
        for b in self.bodies:
            out.append(slice(off, off + b.n_pts))
            off += b.n_pts
        return out

    def all_coords(self) -> np.ndarray:
        return np.concatenate([b.coords for b in self.bodies], axis=0)

    def avg_forces(self, f) -> list[np.ndarray]:
        """Integrated force per body: -sum over points (f is the force the
        body applies to the fluid; reference: singlebodypoints.cpp:207-236
        calculateAvgForces)."""
        f = np.asarray(f)
        return [-f[s].sum(axis=0) for s in self.slices()]
