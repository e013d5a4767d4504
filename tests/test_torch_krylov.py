"""The port's Krylov solvers (``cg``, ``bicgstab``, ``make_solver``) and
``extract_diagonal`` against the JAX package on the same operators and
numpy inputs, in float64: the momentum operator A u = u/dt - cnu L u (a
dict of velocity components) and the negated Poisson operator -D B1 G on
stretched 2D and 3D grids with and without periodic axes.  Iteration
counts and ok flags are equal, solutions agree to 1e-10 of their maximum,
diagonals to 1e-12.
"""

import numpy as np
import pytest
import torch

from petibm_tpu_torch.linalg import krylov
from petibm_tpu_torch.linalg.probe_diag import extract_diagonal

torch.set_num_threads(2)

DT, CNU = 0.01, 0.05


def _axis(d, n, ratio):
    return {"direction": d, "start": 0.0, "subDomains": [
        {"end": 0.5, "cells": n // 2, "stretchRatio": ratio},
        {"end": 1.0, "cells": n - n // 2, "stretchRatio": 1.0 / ratio}]}


def _config(name):
    if name == "2d_walled":
        mesh = [_axis("x", 14, 1.1), _axis("y", 11, 1.05)]
        periodic = (False, False)
    else:  # 3d, x and z periodic with odd extents
        mesh = [_axis("x", 7, 1.0), _axis("y", 6, 1.1), _axis("z", 9, 1.0)]
        periodic = (True, False, True)
    fields = "uvw"[:len(mesh)]
    bcs = []
    for ax, per in zip("xyz", periodic):
        for side, val in (("Minus", 0.0), ("Plus", 1.0)):
            bcs.append({"location": ax + side, **{
                f: ["PERIODIC", 0.0] if per else ["DIRICHLET", val]
                for f in fields}})
    return {"mesh": mesh, "flow": {"nu": 0.01, "boundaryConditions": bcs}}


def _operators(name):
    """(JAX, port) momentum and negated Poisson closures, and the mesh."""
    import jax.numpy as jnp
    from petibm_tpu.boundary import BoundarySet as JBC
    from petibm_tpu.mesh import StaggeredMesh as JMesh
    from petibm_tpu.operators import (make_bn, make_divergence,
                                      make_gradient, make_laplacian)
    from petibm_tpu_torch.boundary import BoundarySet
    from petibm_tpu_torch.mesh import StaggeredMesh
    from petibm_tpu_torch.operators import bn, stencil

    cfg = _config(name)
    jmesh = JMesh(cfg)
    jbcs = JBC(jmesh, cfg)
    f64 = jnp.float64
    jlap = make_laplacian(jmesh, jbcs, f64)
    jgrad, jdiv = make_gradient(jmesh, f64), make_divergence(jmesh, jbcs, f64)
    jbn = make_bn(jlap, DT, CNU, 1)
    mesh = StaggeredMesh(cfg)
    bcs = BoundarySet(mesh, cfg)
    kw = dict(dtype=torch.float64, device="cpu")
    lap = stencil.make_laplacian(mesh, bcs, **kw)
    grad, div = stencil.make_gradient(mesh, **kw), stencil.make_divergence(
        mesh, bcs, **kw)
    tbn = bn.make_bn(lap, DT, CNU)

    def jA(u):
        lu = jlap(u, None, homogeneous=True)
        return {k: u[k] / DT - CNU * lu[k] for k in u}

    def tA(u):
        lu = lap(u, None, homogeneous=True)
        return {k: u[k] / DT - CNU * lu[k] for k in u}

    def jP(phi):
        return -jdiv(jbn(jgrad(phi)), None, homogeneous=True)

    def tP(phi):
        return -div(tbn(grad(phi)), None, homogeneous=True)

    return (jA, tA), (jP, tP), mesh


def _rng_fields(mesh, seed):
    from petibm_tpu_torch.types import Field

    rng = np.random.default_rng(seed)
    q = {"uvw"[c]: rng.standard_normal(mesh.shape(Field(c)))
         for c in range(mesh.dim)}
    p = rng.standard_normal(mesh.shape(Field.P))
    return q, p - p.mean()


def _jax(tree):
    import jax.numpy as jnp

    if isinstance(tree, dict):
        return {k: jnp.asarray(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: torch.as_tensor(v) for k, v in tree.items()}
    return torch.as_tensor(tree)


def _assert_solutions_close(got, want, tol=1e-10):
    got = got if isinstance(got, dict) else {"x": got}
    want = want if isinstance(want, dict) else {"x": want}
    for k in want:
        w = np.asarray(want[k])
        assert np.abs(got[k].numpy() - w).max() <= tol * np.abs(w).max(), k


def _host(result):
    import jax

    r = jax.device_get(result)
    return int(r.iters), bool(r.converged), float(r.residual)


CASES = {
    # (operator, method, Jacobi pc, opts)
    "cg_poisson_jacobi": ("poisson", "cg", True, {}),
    "cg_poisson_none": ("poisson", "cg", False, {"rtol": 1e-8}),
    "bicgstab_momentum_jacobi": ("momentum", "bicgstab", True, {}),
    "bicgstab_momentum_none": ("momentum", "bicgstab", False,
                               {"atol": 1e-9}),
    "cg_momentum_maxiter": ("momentum", "cg", True,
                            {"atol": 1e-30, "max_it": 3}),
    "bicgstab_poisson_maxiter": ("poisson", "bicgstab", False,
                                 {"atol": 1e-30, "max_it": 2}),
}


@pytest.mark.parametrize("mesh_name", ["2d_walled", "3d_periodic"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_solvers_match_jax(case, mesh_name):
    from petibm_tpu.linalg.krylov import make_solver as jmake
    from petibm_tpu.linalg.probe_diag import extract_diagonal as jdiag

    which, method, jacobi, extra = CASES[case]
    (jA, tA), (jP, tP), mesh = _operators(mesh_name)
    q, p = _rng_fields(mesh, seed=1)
    jop, top, b = (jA, tA, q) if which == "momentum" else (jP, tP, p)
    x0 = ({k: 0.1 * v for k, v in q.items()} if which == "momentum"
          else np.zeros_like(p))
    opts = dict({"type": method, "atol": 1e-8, "rtol": 0.0}, **extra)
    jM = tM = None
    if jacobi:
        jd = jdiag(jop, _jax(x0), radius=1)
        td = extract_diagonal(top, _torch(x0), radius=1)
        if which == "momentum":
            def jM(r):
                return {k: r[k] / jd[k] for k in r}

            def tM(r):
                return {k: r[k] / td[k] for k in r}
        else:
            def jM(r):
                return r / jd

            def tM(r):
                return r / td
    want = jmake(jop, opts, M=jM)(_jax(b), _jax(x0))
    got = krylov.make_solver(top, opts, M=tM)(_torch(b), _torch(x0))
    iters, ok, res = _host(want)
    assert (got.iters, got.converged) == (iters, ok)
    if "maxiter" in case:
        assert got.iters == opts["max_it"] and not got.converged
    else:
        assert ok and iters > 0
    assert got.residual == pytest.approx(res, rel=1e-4)
    _assert_solutions_close(got.x, want.x)


@pytest.mark.parametrize("mesh_name", ["2d_walled", "3d_periodic"])
def test_extract_diagonal_matches_jax(mesh_name):
    from petibm_tpu.linalg.probe_diag import extract_diagonal as jdiag

    (jA, tA), (jP, tP), mesh = _operators(mesh_name)
    q, p = _rng_fields(mesh, seed=2)
    for jop, top, tmpl in ((jA, tA, q), (jP, tP, p)):
        want = jdiag(jop, _jax(tmpl), radius=1)
        got = extract_diagonal(top, _torch(tmpl), radius=1)
        if isinstance(tmpl, dict):
            assert list(got) == list(tmpl)
        _assert_solutions_close(got, want, tol=1e-12)


def test_extract_diagonal_is_the_diagonal():
    """Probing a small dense operator returns exactly its diagonal,
    including the periodic wrap (odd extents need a wider colouring)."""
    rng = np.random.default_rng(3)
    n = 7
    band = np.diag(rng.uniform(1, 2, n)) + np.diag(rng.uniform(size=n - 1),
                                                   1)
    band += np.diag(rng.uniform(size=n - 1), -1)
    band[0, -1], band[-1, 0] = 0.3, 0.4
    mat = torch.as_tensor(band)
    got = extract_diagonal(lambda x: mat @ x, torch.zeros(n, dtype=torch.float64))
    assert torch.equal(got, torch.diagonal(mat))


def test_make_solver_binds_options():
    seen = {}

    def fake(A, b, x0, M=None, atol=None, rtol=None, maxiter=None):
        seen.update(A=A, M=M, atol=atol, rtol=rtol, maxiter=maxiter)
        return "done"

    ident = lambda x: x  # noqa: E731
    saved = krylov._METHODS["bicgstab"]
    krylov._METHODS["bicgstab"] = fake
    try:
        solve = krylov.make_solver(ident, {"type": "bicgstab", "atol": 2e-7,
                                           "rtol": 1e-3, "max_it": 17},
                                   M=ident)
        assert solve(1.0, 0.0) == "done"
    finally:
        krylov._METHODS["bicgstab"] = saved
    assert seen == dict(A=ident, M=ident, atol=2e-7, rtol=1e-3, maxiter=17)
    with pytest.raises(KeyError):
        krylov.make_solver(ident, {"type": "gmres"})
