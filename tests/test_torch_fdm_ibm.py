"""The port's fast-diagonalization solvers, its refinement loop and its
delta operators against the JAX package: FastDiagPoisson/Helmholtz solves
in float64 to 1e-10 (nullspace case included), make_fdm_solver iteration
counts and ok flags, and the delta windows, E u, H f and dense EBNH blocks
to 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petibm_tpu.boundary as jb
import petibm_tpu.ibm.interp as jinterp
import petibm_tpu.linalg.fdm as jfdm
import petibm_tpu.mesh as jm
import petibm_tpu_torch.boundary as tb
import petibm_tpu_torch.ibm.interp as tinterp
import petibm_tpu_torch.linalg.fdm as tfdm
import petibm_tpu_torch.mesh as tm
from petibm_tpu.types import Field
from petibm_tpu_torch.linalg.mg import poisson_level0
from petibm_tpu_torch.operators.cuda_stencil import poisson_apply_separable

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")


def _stretched(n, r=1.03, h0=0.02):
    return h0 * r ** np.arange(n)


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-300))


POISSON_CASES = {
    "2d": ([_stretched(17), _stretched(13, 1.05)], [False, False]),
    "2d_xperiodic": ([_stretched(12), _stretched(9)], [True, False]),
    "2d_periodic_uniform": ([np.full(10, 0.1), _stretched(8)], [True, False]),
    "3d": ([_stretched(9), _stretched(7, 1.04), _stretched(6)],
           [False, False, False]),
    "3d_zperiodic": ([_stretched(8), _stretched(6), np.full(7, 0.2)],
                     [False, False, True]),
}


@pytest.mark.parametrize("name", sorted(POISSON_CASES))
def test_fast_diag_poisson_matches_jax(name):
    dxp, periodic = POISSON_CASES[name]
    jsolver = jfdm.FastDiagPoisson(dxp, periodic, dtype=jnp.float64,
                                   scale=0.01, use_fft=False)
    tsolver = tfdm.FastDiagPoisson(dxp, periodic, scale=0.01, **F64)
    shape = tuple(len(w) for w in reversed(dxp))
    b = np.random.default_rng(2).standard_normal(shape)
    _close(tsolver.solve(torch.as_tensor(b)), jsolver.solve(jnp.asarray(b)),
           1e-10)


def test_nullspace_component_discarded():
    """Twin of test_fdm.py::test_nullspace_component_discarded: a constant
    (nullspace) component of b is ignored, and A x recovers the consistent
    part (A here is the port's K1 operator)."""
    dxp = [_stretched(17), _stretched(19)]
    fdm = tfdm.FastDiagPoisson(dxp, [False, False], scale=0.5, **F64)
    jsolver = jfdm.FastDiagPoisson(dxp, [False, False], dtype=jnp.float64,
                                   scale=0.5)
    level = poisson_level0(dxp, [False, False], scale=0.5, **F64)
    rng = np.random.default_rng(3)
    b0 = rng.standard_normal(level.shape)
    b0 -= b0.mean()
    x0 = fdm.solve(torch.as_tensor(b0))
    x1 = fdm.solve(torch.as_tensor(b0 + 5.0))
    np.testing.assert_allclose(x0.numpy(), x1.numpy(), atol=1e-9)
    r = torch.as_tensor(b0) - poisson_apply_separable(x0, level)
    assert float(torch.linalg.norm(r)) < 1e-9 * float(torch.linalg.norm(x0) + 1)
    _close(x1, jsolver.solve(jnp.asarray(b0 + 5.0)), 1e-10)


def _channel(ndim=2):
    axes = [{"direction": "x", "start": 0.0, "subDomains": [
        {"end": 1.0, "cells": 18, "stretchRatio": 1.06}]},
        {"direction": "y", "start": 0.0, "subDomains": [
            {"end": 1.0, "cells": 14, "stretchRatio": 1.0}]},
        {"direction": "z", "start": 0.0, "subDomains": [
            {"end": 1.0, "cells": 6, "stretchRatio": 0.95}]}][:ndim]
    names = ("u", "v", "w")[:ndim]

    def entry(loc, bct, uval):
        return {"location": loc, **{f: [bct, uval if f == "u" else 0.0]
                                    for f in names}}

    bcs = [entry("xMinus", "DIRICHLET", 1.0), entry("xPlus", "CONVECTIVE", 1.0),
           entry("yMinus", "DIRICHLET", 0.0), entry("yPlus", "NEUMANN", 0.0)]
    if ndim == 3:
        bcs += [entry("zMinus", "PERIODIC", 0.0),
                entry("zPlus", "PERIODIC", 0.0)]
    return {"mesh": axes, "flow": {"nu": 0.02, "boundaryConditions": bcs}}


@pytest.mark.parametrize("ndim", [2, 3])
def test_fast_diag_helmholtz_matches_jax(ndim):
    cfg = _channel(ndim)
    jmesh, tmesh = jm.StaggeredMesh(cfg), tm.StaggeredMesh(cfg)
    jbc, tbc = jb.BoundarySet(jmesh, cfg), tb.BoundarySet(tmesh, cfg)
    dt, cnu = 0.01, 0.5 * 0.02
    rng = np.random.default_rng(9)
    for c in range(ndim):
        jh = jfdm.FastDiagHelmholtz(jfdm.helmholtz_lines(jmesh, jbc, c), dt,
                                    cnu, dtype=jnp.float64, use_fft=False)
        th = tfdm.FastDiagHelmholtz(tfdm.helmholtz_lines(tmesh, tbc, c), dt,
                                    cnu, **F64)
        b = rng.standard_normal(jmesh.shape(Field(c)))
        _close(th.solve(torch.as_tensor(b)), jh.solve(jnp.asarray(b)), 1e-10)


class _Scaled:
    """An approximate inverse: the exact FDM solve times a factor."""

    def __init__(self, fdm, factor):
        self.fdm, self.factor = fdm, factor

    def solve(self, r):
        return self.factor * self.fdm.solve(r)


REFINE_CASES = {
    # (inverse factor, atol, rtol, max_it, warm start)
    "exact": (1.0, 1e-12, 0.0, 50, False),
    "damped": (0.6, 1e-11, 0.0, 50, True),
    "rtol": (0.75, 0.0, 1e-9, 50, False),
    "max_it": (0.5, 1e-14, 0.0, 3, False),
    "stagnating": (1e-3, 1e-12, 0.0, 500, False),
}


@pytest.mark.parametrize("name", sorted(REFINE_CASES))
def test_make_fdm_solver_matches_jax(name):
    factor, atol, rtol, max_it, warm = REFINE_CASES[name]
    dxp = [_stretched(25), _stretched(31)]
    opts = {"atol": atol, "rtol": rtol, "max_it": max_it}
    jmg_fdm = jfdm.FastDiagPoisson(dxp, [False, False], dtype=jnp.float64,
                                   scale=0.01)
    from petibm_tpu.linalg.mg import PoissonMG

    mg = PoissonMG(dxp, [False, False], dtype=jnp.float64, scale=0.01)
    jsolve = jfdm.make_fdm_solver(_Scaled(jmg_fdm, factor),
                                  lambda p: mg.apply_op(0, p), opts)
    level = poisson_level0(dxp, [False, False], scale=0.01, **F64)
    tsolve = tfdm.make_fdm_solver(
        _Scaled(tfdm.FastDiagPoisson(dxp, [False, False], scale=0.01, **F64),
                factor),
        lambda p: poisson_apply_separable(p, level), opts)
    rng = np.random.default_rng(11)
    b = rng.standard_normal(level.shape)
    b -= b.mean()
    x0 = 0.1 * rng.standard_normal(level.shape) if warm else np.zeros_like(b)
    want = jsolve(jnp.asarray(b), jnp.asarray(x0))
    got = tsolve(torch.as_tensor(b), torch.as_tensor(x0))
    assert got.iters == int(want.iters)
    assert got.converged == bool(want.converged)
    # residuals agree down to the rounding floor eps * ||b||
    assert got.residual == pytest.approx(float(want.residual), rel=1e-6,
                                         abs=1e-13 * np.linalg.norm(b))
    _close(got.x, want.x, 1e-10)


def test_make_fdm_solver_dict_operands_match_jax():
    """The momentum form: a dict of components, norms over both."""
    cfg = _channel(2)
    jmesh, tmesh = jm.StaggeredMesh(cfg), tm.StaggeredMesh(cfg)
    jbc, tbc = jb.BoundarySet(jmesh, cfg), tb.BoundarySet(tmesh, cfg)
    dt, cnu = 0.01, 0.01
    jh = {n: jfdm.FastDiagHelmholtz(jfdm.helmholtz_lines(jmesh, jbc, c), dt,
                                    cnu, dtype=jnp.float64)
          for c, n in enumerate("uv")}
    th = {n: tfdm.FastDiagHelmholtz(tfdm.helmholtz_lines(tmesh, tbc, c), dt,
                                    cnu, **F64)
          for c, n in enumerate("uv")}

    class JInv:
        @staticmethod
        def solve(r):
            return {k: 0.7 * jh[k].solve(v) for k, v in r.items()}

    class TInv:
        @staticmethod
        def solve(r):
            return {k: 0.7 * th[k].solve(v) for k, v in r.items()}

    def jA(x):
        return {k: v / dt for k, v in x.items()}

    def tA(x):
        return {k: v / dt for k, v in x.items()}

    opts = {"atol": 1e-9, "rtol": 0.0, "max_it": 100}
    rng = np.random.default_rng(4)
    b = {n: rng.standard_normal(jmesh.shape(Field(c)))
         for c, n in enumerate("uv")}
    want = jfdm.make_fdm_solver(JInv, jA, opts)(
        {k: jnp.asarray(v) for k, v in b.items()},
        {k: jnp.zeros(v.shape) for k, v in b.items()})
    got = tfdm.make_fdm_solver(TInv, tA, opts)(
        {k: torch.as_tensor(v) for k, v in b.items()},
        {k: torch.zeros(v.shape, dtype=torch.float64) for k, v in b.items()})
    assert (got.iters, got.converged) == (int(want.iters),
                                          bool(want.converged))
    for k in b:
        _close(got.x[k], want.x[k], 1e-10)


# ----------------------------------------------------------------------
def _ib_mesh(ndim, periodic):
    axes = [{"direction": d, "start": -1.0, "subDomains": [
        {"end": -0.3, "cells": 6, "stretchRatio": 0.9},
        {"end": 0.3, "cells": 12, "stretchRatio": 1.0},
        {"end": 1.0, "cells": 6, "stretchRatio": 1.1}]}
        for d in ("x", "y", "z")[:ndim]]
    names = ("u", "v", "w")[:ndim]
    bcs = []
    for d in ("x", "y", "z")[:ndim]:
        bct = "PERIODIC" if (periodic and d == "x") else "DIRICHLET"
        for side in ("Minus", "Plus"):
            bcs.append({"location": d + side,
                        **{f: [bct, 0.0] for f in names}})
    cfg = {"mesh": axes, "flow": {"nu": 0.01, "boundaryConditions": bcs}}
    return cfg


IB_CASES = [(2, False, "ROMA_ET_AL_1999"), (2, True, "PESKIN_2002"),
            (3, False, "ROMA_ET_AL_1999"), (3, True, "PESKIN_2002")]


@pytest.mark.parametrize("ndim,periodic,kernel", IB_CASES)
def test_delta_windows_interp_spread_ebnh_match_jax(ndim, periodic, kernel):
    cfg = _ib_mesh(ndim, periodic)
    jmesh, tmesh = jm.StaggeredMesh(cfg), tm.StaggeredMesh(cfg)
    rng = np.random.default_rng(5)
    npts = 23
    X = rng.uniform(-0.25, 0.25, size=(npts, ndim))
    if periodic:  # a point whose window wraps across the periodic x faces
        X[0, 0] = 0.97
    jd = jinterp.make_delta_op(jmesh, kernel, jnp.float64, n_pts=npts)
    td = tinterp.make_delta_op(tmesh, kernel, n_pts=npts, **F64)
    jwin = jd.windows(jnp.asarray(X))
    twin = td.windows(torch.as_tensor(X))
    for c in range(ndim):
        for key in ("sd", "sv"):
            for d in range(ndim):
                _close(twin[c][key][d], jwin[c][key][d], 1e-12)
    q = {n: rng.standard_normal(jmesh.shape(Field(c)))
         for c, n in enumerate(("u", "v", "w")[:ndim])}
    _close(td.interpolate({k: torch.as_tensor(v) for k, v in q.items()}, twin),
           jd.interpolate({k: jnp.asarray(v) for k, v in q.items()}, jwin),
           1e-12)
    f = rng.standard_normal((npts, ndim))
    got = td.spread(torch.as_tensor(f), twin)
    want = jd.spread(jnp.asarray(f), jwin)
    for k in want:
        _close(got[k], want[k], 1e-12)
    for a, b in zip(tinterp.dense_ebnh_blocks(twin, ndim, 0.02),
                    jinterp.dense_ebnh_blocks(jwin, ndim, 0.02, jnp.float64)):
        _close(a, b, 1e-12)
