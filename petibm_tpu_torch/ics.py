"""Symbolic initial conditions.

Reference (src/parser/parser.cpp:396-435 parseICs;
src/solution/solutionsimple.cpp:122-228): ``flow.initialVelocity`` entries
and optional ``flow.initialPressure`` are expressions in (x, y, z, t, nu),
compiled with SymEngine and evaluated pointwise.  Here sympy lambdifies the
expressions onto numpy meshgrids of the staggered coordinates — the same
math, vectorized.

Copy of ``petibm_tpu/ics.py`` (held equal to the original by
tests/test_torch_host.py), except that sympy is imported inside
``_compile``.
"""

from __future__ import annotations

import numpy as np

from .mesh import StaggeredMesh
from .types import Field


def _compile(expr) -> callable:
    import sympy

    e = sympy.sympify(str(expr))
    return sympy.lambdify(sympy.symbols("x y z t nu"), e, modules="numpy")


def _eval_on_grid(fn, mesh: StaggeredMesh, field: Field, t: float, nu: float):
    coords = [mesh.coord(field, d) for d in range(mesh.dim)]
    # meshgrid in (z, y, x) array order
    grids = np.meshgrid(*reversed(coords), indexing="ij")
    # map back to x, y, z argument order
    xyz = list(reversed(grids)) + [np.zeros_like(grids[0])] * (3 - mesh.dim)
    out = fn(xyz[0], xyz[1], xyz[2], t, nu)
    return np.broadcast_to(np.asarray(out, dtype=np.float64),
                           mesh.shape(field)).copy()


def initial_fields(config: dict, mesh: StaggeredMesh, t: float = 0.0) -> dict:
    """Evaluate ICs for velocity components and pressure; returns a dict of
    float64 numpy arrays keyed u/v/w/p."""
    flow = config.get("flow", {})
    nu = float(flow.get("nu", 0.0))
    exprs = flow.get("initialVelocity", [0.0] * mesh.dim)
    if len(exprs) < mesh.dim:
        raise ValueError("initialVelocity needs one entry per dimension")
    out = {}
    names = ("u", "v", "w")
    for c in range(mesh.dim):
        fn = _compile(exprs[c])
        out[names[c]] = _eval_on_grid(fn, mesh, Field(c), t, nu)
    p_expr = flow.get("initialPressure", 0)
    out["p"] = _eval_on_grid(_compile(p_expr), mesh, Field.P, t, nu)
    return out
