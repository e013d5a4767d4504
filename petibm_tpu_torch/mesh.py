"""Staggered, stretched Cartesian mesh.

TPU-native re-design of the reference's CartesianMesh
(reference: src/mesh/cartesianmesh.cpp, include/petibm/mesh.h).

The reference builds five grids (u, v, w, pressure, vertex) plus PETSc DMDA
decompositions and four index spaces.  Here the mesh is purely *metric*
information: per-field, per-direction 1D gridline coordinates and cell
widths (with one ghost entry on each side), kept as float64 numpy arrays at
setup time.  Fields are dense arrays of shape ``(nz, ny, nx)`` (3D) or
``(ny, nx)`` (2D) — x fastest, matching the reference's k/j/i loop order and
HDF5 layout — and all the reference's index-space machinery
(local/natural/global/packed, reference: cartesianmesh.cpp:592-795)
disappears: an (i, j, k) tuple indexes the array directly, and distribution
is done by sharding the dense arrays over a ``jax.sharding.Mesh``.

Copy of ``petibm_tpu/mesh.py`` (held equal to the original by
tests/test_torch_host.py).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .types import BCType, Dir, Field


def stretch_grid(begin: float, end: float, n: int, ratio: float) -> np.ndarray:
    """Geometric-ratio cell widths on one sub-domain.

    ``dL[0] = (end-begin)(r-1)/(r^n - 1)``, ``dL[i] = dL[i-1]*r``
    (reference: include/petibm/misc.h:148-163).
    """
    if n <= 0:
        raise ValueError(f"sub-domain must have at least 1 cell, got {n}")
    from . import native

    if native.available():
        out = native.stretch_grid(begin, end, n, ratio)
        if out is not None:
            return out
    if abs(ratio - 1.0) <= 1e-12:
        return np.full(n, (end - begin) / n, dtype=np.float64)
    h0 = (end - begin) * (ratio - 1.0) / (ratio**n - 1.0)
    return h0 * ratio ** np.arange(n, dtype=np.float64)


def parse_subdomains(begin: float, subdomains: Sequence[dict]) -> tuple[np.ndarray, float]:
    """Concatenate per-sub-domain cell widths along one axis
    (reference: src/parser/parser.cpp:298-356)."""
    widths = []
    lo = begin
    for sub in subdomains:
        hi = float(sub["end"])
        n = int(sub["cells"])
        r = float(sub.get("stretchRatio", 1.0))
        widths.append(stretch_grid(lo, hi, n, r))
        lo = hi
    return np.concatenate(widths), lo


@dataclasses.dataclass(frozen=True)
class GridLine:
    """1D gridline data for one (field, direction) pair.

    ``coord`` and ``dl`` have length ``n + 2``: index 0 is the lower ghost
    point (the reference's index -1, cartesianmesh.cpp:328-331), indices
    1..n are the valid points, index n+1 the upper ghost.
    """

    n: int
    coord: np.ndarray  # ghosted, length n + 2
    dl: np.ndarray  # ghosted, length n + 2

    @property
    def interior_coord(self) -> np.ndarray:
        return self.coord[1:-1]

    @property
    def interior_dl(self) -> np.ndarray:
        return self.dl[1:-1]

    def dneg(self) -> np.ndarray:
        """Distance from each valid point to its lower neighbor (ghost-aware);
        length n (reference: createlaplacian.cpp:141-143)."""
        return self.coord[1:-1] - self.coord[:-2]

    def dpos(self) -> np.ndarray:
        """Distance from each valid point to its upper neighbor; length n."""
        return self.coord[2:] - self.coord[1:-1]


def _pressure_line(dxp: np.ndarray, lo: float, hi: float, periodic: bool) -> GridLine:
    """Pressure (cell-center) gridline with ghost cells.

    The reference stores no pressure ghosts (cartesianmesh.cpp:156); ghosts
    here exist only so periodic wraparound and vorticity post-processing have
    coordinates to work with, and follow the velocity-grid ghost convention
    (periodic: image of opposite-side cell; otherwise mirror of edge cell,
    cartesianmesh.cpp:301-325).
    """
    n = len(dxp)
    centers = lo + np.cumsum(dxp) - 0.5 * dxp
    coord = np.empty(n + 2)
    dl = np.empty(n + 2)
    coord[1:-1] = centers
    dl[1:-1] = dxp
    if periodic:
        coord[0] = lo - 0.5 * dxp[-1]
        coord[-1] = hi + 0.5 * dxp[0]
        dl[0] = dxp[-1]
        dl[-1] = dxp[0]
    else:
        coord[0] = lo - 0.5 * dxp[0]
        coord[-1] = hi + 0.5 * dxp[-1]
        dl[0] = dxp[0]
        dl[-1] = dxp[-1]
    return GridLine(n=n, coord=coord, dl=dl)


def _vertex_line(dxp: np.ndarray, lo: float) -> GridLine:
    """Vertex (cell-face) gridline; n+1 points, no meaningful ghosts
    (reference: cartesianmesh.cpp:177-206)."""
    n = len(dxp) + 1
    verts = np.empty(n)
    verts[0] = lo
    verts[1:] = lo + np.cumsum(dxp)
    coord = np.empty(n + 2)
    coord[1:-1] = verts
    coord[0] = verts[0] - dxp[0]
    coord[-1] = verts[-1] + dxp[-1]
    dl = np.empty(n + 2)
    dl[1:-1] = np.concatenate(([dxp[0]], 0.5 * (dxp[:-1] + dxp[1:]), [dxp[-1]]))
    dl[0] = dxp[0]
    dl[-1] = dxp[-1]
    return GridLine(n=n, coord=coord, dl=dl)


def _velocity_line_same_dir(
    dxp: np.ndarray, lo: float, hi: float, periodic: bool
) -> GridLine:
    """Velocity gridline along the component's own direction: points on
    interior cell faces (reference: cartesianmesh.cpp:224-280).

    Non-periodic: n = np - 1 points at interior vertices; the lower/upper
    ghosts sit on the domain faces.  Periodic: n = np points (the point on
    the max face is kept), ghosts are wrap images.
    """
    npre = len(dxp)
    verts = lo + np.cumsum(dxp)  # vertices 1..np (max face last)
    # half-sum cell widths: dL[i] = (dxp[i] + dxp[i+1])/2 at interior vertex i+1
    half = 0.5 * (dxp[:-1] + dxp[1:])
    if periodic:
        n = npre
        coord = np.empty(n + 2)
        coord[0] = lo  # ghost on the min face (image of the max-face point)
        coord[1:-1] = verts
        coord[-1] = hi + dxp[0]  # image of the first interior point
        dl = np.empty(n + 2)
        dl[1:-2] = half
        dl[-2] = 0.5 * (dxp[0] + dxp[-1])  # point on the max face
        dl[0] = dl[-2]  # ghost = image of max-face point
        dl[-1] = half[0] if npre > 1 else dl[-2]  # image of 1st interior point
    else:
        n = npre - 1
        coord = np.empty(n + 2)
        coord[0] = lo
        coord[1:] = verts
        dl = np.empty(n + 2)
        dl[0] = dxp[0]  # ghost on the min face (cartesianmesh.cpp:245-247)
        dl[1:-1] = half
        dl[-1] = dxp[-1]  # ghost on the max face (cartesianmesh.cpp:279)
    return GridLine(n=n, coord=coord, dl=dl)


def build_gridline(
    field: Field, direction: Dir, dxp: np.ndarray, lo: float, hi: float, periodic: bool
) -> GridLine:
    """Gridline for a (field, direction) pair on the staggered mesh."""
    if field == Field.P:
        return _pressure_line(dxp, lo, hi, periodic)
    if field == Field.VERTEX:
        return _vertex_line(dxp, lo)
    if int(field) == int(direction):
        return _velocity_line_same_dir(dxp, lo, hi, periodic)
    return _pressure_line(dxp, lo, hi, periodic)


class StaggeredMesh:
    """The five staggered grids of one simulation.

    Array layout convention for fields on this mesh: shape ``(ny, nx)`` in
    2D and ``(nz, ny, nx)`` in 3D — direction ``d`` lives on array axis
    ``ndim - 1 - d``.
    """

    def __init__(self, config: dict):
        mesh_node = config["mesh"]
        self.dim = len(mesh_node)
        if self.dim not in (2, 3):
            raise ValueError(f"mesh must be 2D or 3D, got {self.dim} axes")

        # per-direction pressure-cell widths and domain bounds
        self.dxp: list[np.ndarray] = [None] * self.dim
        self.min = np.zeros(self.dim)
        self.max = np.zeros(self.dim)
        for ax in mesh_node:
            d = int(_parse_dir(ax["direction"]))
            if d >= self.dim:
                raise ValueError(f"direction {ax['direction']} in a {self.dim}D mesh")
            lo = float(ax["start"])
            widths, hi = parse_subdomains(lo, ax["subDomains"])
            self.dxp[d] = widths
            self.min[d] = lo
            self.max[d] = hi
        for d in range(self.dim):
            if self.dxp[d] is None:
                raise ValueError(f"missing mesh axis {Dir(d).name}")

        # periodicity per direction, derived from the BC table like the
        # reference's checkPeriodicBC (src/misc/misc.cpp:19-83)
        self.periodic = _periodic_dirs(config, self.dim)

        self.fields = [Field(i) for i in range(self.dim)] + [Field.P, Field.VERTEX]
        # lines[field][dir] -> GridLine
        self.lines: dict[Field, list[GridLine]] = {}
        for f in self.fields:
            self.lines[f] = [
                build_gridline(f, Dir(d), self.dxp[d], self.min[d], self.max[d],
                               self.periodic[d])
                for d in range(self.dim)
            ]

    # --- shapes -----------------------------------------------------------
    def shape(self, field: Field) -> tuple[int, ...]:
        """Array shape (z, y, x ordering) of a field's interior points."""
        ns = [self.lines[field][d].n for d in range(self.dim)]
        return tuple(reversed(ns))

    def n(self, field: Field, direction: Dir | int) -> int:
        return self.lines[field][int(direction)].n

    @property
    def pN(self) -> int:
        return int(np.prod(self.shape(Field.P)))

    @property
    def UN(self) -> int:
        return int(sum(np.prod(self.shape(Field(c))) for c in range(self.dim)))

    # --- coordinate access ------------------------------------------------
    def coord(self, field: Field, direction: Dir | int) -> np.ndarray:
        """Interior coordinates along one direction."""
        return self.lines[field][int(direction)].interior_coord

    def dl(self, field: Field, direction: Dir | int) -> np.ndarray:
        """Interior cell widths along one direction."""
        return self.lines[field][int(direction)].interior_dl

    def coord_ghosted(self, field: Field, direction: Dir | int) -> np.ndarray:
        return self.lines[field][int(direction)].coord

    def dl_ghosted(self, field: Field, direction: Dir | int) -> np.ndarray:
        return self.lines[field][int(direction)].dl

    def axis_of(self, direction: Dir | int) -> int:
        """Array axis carrying spatial direction ``direction``."""
        return self.dim - 1 - int(direction)

    def bcast(self, field: Field, direction: Dir | int, arr1d: np.ndarray) -> np.ndarray:
        """Reshape a per-direction 1D metric array for broadcasting against a
        field array (z, y, x ordering)."""
        shape = [1] * self.dim
        shape[self.axis_of(direction)] = len(arr1d)
        return np.asarray(arr1d).reshape(shape)

    def cell_widths(self, field: Field) -> list[np.ndarray]:
        """Broadcastable dL arrays, one per direction."""
        return [self.bcast(field, d, self.dl(field, d)) for d in range(self.dim)]

    def info(self) -> str:
        lines = ["Cartesian staggered grid:",
                 f"  dim: {self.dim}",
                 "  domain: " + "; ".join(
                     f"[{self.min[d]}, {self.max[d]}]" for d in range(self.dim)),
                 "  periodic: " + ", ".join(
                     f"{Dir(d).name}={bool(self.periodic[d])}" for d in range(self.dim)),
                 "  pressure cells: " + " x ".join(
                     str(self.n(Field.P, d)) for d in range(self.dim))]
        for c in range(self.dim):
            lines.append(
                f"  {Field(c).name.lower()} points: " + " x ".join(
                    str(self.n(Field(c), d)) for d in range(self.dim)))
        return "\n".join(lines)


def _parse_dir(s) -> Dir:
    from .types import STR2DIR

    if isinstance(s, Dir):
        return s
    return STR2DIR[str(s)]


def _periodic_dirs(config: dict, dim: int) -> list[bool]:
    """Which directions are periodic, from flow.boundaryConditions
    (reference: src/misc/misc.cpp:19-83 checkPeriodicBC)."""
    from .types import STR2BCLOC, STR2BCTYPE

    flow = config.get("flow", {})
    bcs = flow.get("boundaryConditions", None)
    if bcs is None:
        return [False] * dim
    # bcTypes[field][loc]
    table: dict[tuple[int, int], BCType] = {}
    for entry in bcs:
        loc = STR2BCLOC[entry["location"]]
        for key, val in entry.items():
            if key == "location":
                continue
            f = int(_parse_field(key))
            table[(f, int(loc))] = STR2BCTYPE[str(val[0])]
    periodic = []
    for d in range(dim):
        flags = [
            table.get((f, 2 * d), BCType.NOBC) == BCType.PERIODIC
            and table.get((f, 2 * d + 1), BCType.PERIODIC) == BCType.PERIODIC
            for f in range(dim)
        ]
        minus = [table.get((f, 2 * d), BCType.NOBC) == BCType.PERIODIC for f in range(dim)]
        plus = [table.get((f, 2 * d + 1), BCType.NOBC) == BCType.PERIODIC for f in range(dim)]
        for f in range(dim):
            if minus[f] != plus[f]:
                raise ValueError(
                    f"periodic BC on only one side of direction {Dir(d).name} "
                    f"for field {Field(f).name}")
        if any(flags) and not all(flags):
            raise ValueError(
                f"not all velocity fields periodic in direction {Dir(d).name}")
        periodic.append(all(flags))
    return periodic


def _parse_field(s) -> Field:
    from .types import STR2FIELD

    if isinstance(s, Field):
        return s
    return STR2FIELD[str(s)]
