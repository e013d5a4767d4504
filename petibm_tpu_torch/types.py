"""Core enums and small types.

Copy of ``petibm_tpu/types.py`` (numpy-free; held equal to the original
by tests/test_torch_host.py).

TPU-native re-design of the reference's type system
(reference: include/petibm/type.h:67-195).  Only the concepts that survive
the JAX re-architecture are kept: directions, fields, BC types/locations,
probe types.  The packed-index machinery of the reference disappears because
fields are dense per-component arrays in a pytree, not packed PETSc Vecs.
"""

from __future__ import annotations

import enum


class Dir(enum.IntEnum):
    """Spatial direction (reference: type.h:67)."""

    X = 0
    Y = 1
    Z = 2


class Field(enum.IntEnum):
    """Field id (reference: type.h:78). 0-2: velocity components, 3: pressure,
    4: vertex grid."""

    U = 0
    V = 1
    W = 2
    P = 3
    VERTEX = 4


class BCType(enum.IntEnum):
    """Boundary-condition type (reference: type.h:94)."""

    NOBC = 0
    PERIODIC = 1
    DIRICHLET = 2
    NEUMANN = 3
    CONVECTIVE = 4


class BCLoc(enum.IntEnum):
    """Boundary location (reference: type.h:110).  ``loc // 2`` is the axis,
    ``loc % 2`` is 0 for the min face and 1 for the max face."""

    XMINUS = 0
    XPLUS = 1
    YMINUS = 2
    YPLUS = 3
    ZMINUS = 4
    ZPLUS = 5

    @property
    def axis(self) -> int:
        return int(self) // 2

    @property
    def is_max(self) -> bool:
        return int(self) % 2 == 1

    @property
    def normal(self) -> float:
        """Outward normal sign along the face axis (reference:
        singleboundaryperiodic.cpp:55)."""
        return 1.0 if self.is_max else -1.0


class ProbeType(enum.IntEnum):
    """Probe type (reference: type.h:122)."""

    POINT = 0
    VOLUME = 1


FIELD_NAMES = ("u", "v", "w", "p", "vertex")

# string -> enum maps mirroring the reference's YAML converters
# (reference: src/misc/type.cpp)
STR2DIR = {"x": Dir.X, "y": Dir.Y, "z": Dir.Z}
STR2FIELD = {"u": Field.U, "v": Field.V, "w": Field.W, "p": Field.P}
STR2BCTYPE = {
    "NOBC": BCType.NOBC,
    "PERIODIC": BCType.PERIODIC,
    "DIRICHLET": BCType.DIRICHLET,
    "NEUMANN": BCType.NEUMANN,
    "CONVECTIVE": BCType.CONVECTIVE,
}
STR2BCLOC = {
    "xMinus": BCLoc.XMINUS,
    "xPlus": BCLoc.XPLUS,
    "yMinus": BCLoc.YMINUS,
    "yPlus": BCLoc.YPLUS,
    "zMinus": BCLoc.ZMINUS,
    "zPlus": BCLoc.ZPLUS,
}
BCLOC2STR = {v: k for k, v in STR2BCLOC.items()}
FIELD2STR = {Field.U: "u", Field.V: "v", Field.W: "w", Field.P: "p"}
