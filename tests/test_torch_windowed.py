"""The windowed delta engine and the matrix-free Krylov force solve: the
port against the JAX package.

The engine (``ibm/interp.py``'s ``WindowedDeltaOp``) against JAX's on
seeded points, in 2D with a periodic direction (a window wrapping across
it) and in 3D, in one chunk and in chunks of 8 points: the windows'
``idx`` equal, ``sd``/``sv`` to 1e-12, E and H to 1e-12, the banded sums
sum(sd * sv, axis=1) to 1e-13; against the port's factor engine (as JAX
tests/test_ibm.py:470-501, 546-); the ``auto`` threshold (:534).

The solver runs that take the Krylov force solve or the windowed gates,
3 steps in float64 with every solver's atol at 1e-12, the port against
the JAX package: the decoupled cylinder (32^2, 24 points) with
``deltaEngine: windowed``, with ``forcesSolver.dense: false``, with BN 2
and with BN 3; the coupled IBPM (30^2, 20 points) with ``deltaEngine:
windowed``; the moving cylinder with ``deltaEngine: windowed`` (the
Krylov path in both packages: no dense fallback).  Every stat is equal
(iteration counts and ok flags), the fields agree to 1e-10 of their
maxima and the forces to 1e-8.
"""

import types

import numpy as np
import pytest
import torch

import petibm_tpu_torch.ibm.interp as tinterp
import petibm_tpu_torch.mesh as tm
from petibm_tpu_torch.convert import state_to_numpy
from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver
from petibm_tpu_torch.solvers.ibpm import IBPMSolver
from petibm_tpu_torch.solvers.rigidkinematics import RigidKinematicsSolver
from petibm_tpu_torch.types import Field

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side, imported here and not with the module: the
    card-only test runs where jax is not installed."""
    import jax
    import jax.numpy as jnp

    import petibm_tpu.ibm.interp as jinterp
    import petibm_tpu.mesh as jm
    import test_torch_decoupledibpm as tdec
    import test_torch_ibpm as tibpm
    import test_torch_rigidkinematics as trk
    from petibm_tpu.solvers.decoupledibpm import DecoupledIBPMSolver
    from petibm_tpu.solvers.ibpm import IBPMSolver
    from petibm_tpu.solvers.rigidkinematics import RigidKinematicsSolver

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, interp=jinterp, mesh=jm, tdec=tdec, tibpm=tibpm,
        trk=trk, Dec=DecoupledIBPMSolver, IBPM=IBPMSolver,
        RK=RigidKinematicsSolver)


def _mesh_config(ndim, periodic_y):
    axes = [{"direction": d, "start": -1.0, "subDomains": [
        {"end": -0.3, "cells": 6, "stretchRatio": 0.9},
        {"end": 0.3, "cells": 12, "stretchRatio": 1.0},
        {"end": 1.0, "cells": 6, "stretchRatio": 1.1}]}
        for d in ("x", "y", "z")[:ndim]]
    names = ("u", "v", "w")[:ndim]
    bcs = []
    for d in ("x", "y", "z")[:ndim]:
        bct = "PERIODIC" if (periodic_y and d == "y") else "DIRICHLET"
        for side in ("Minus", "Plus"):
            bcs.append({"location": d + side,
                        **{f: [bct, 0.0] for f in names}})
    return {"mesh": axes, "flow": {"nu": 0.01, "boundaryConditions": bcs}}


#: (dim, periodic y, kernel)
ENGINE_CASES = {
    "2d_yperiodic": (2, True, "ROMA_ET_AL_1999"),
    "2d_peskin": (2, False, "PESKIN_2002"),
    "3d": (3, False, "ROMA_ET_AL_1999"),
    "3d_yperiodic_peskin": (3, True, "PESKIN_2002"),
}


def _points(ndim, periodic_y, npts=23, seed=5):
    X = np.random.default_rng(seed).uniform(-0.25, 0.25, size=(npts, ndim))
    X[1, 0] = -0.97  # a window clamped at the x wall
    if periodic_y:
        X[0, 1] = 0.97  # a window that wraps across the periodic y faces
    return X


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))


def _engine_case(name):
    ndim, periodic_y, kernel = ENGINE_CASES[name]
    return ndim, periodic_y, kernel, _mesh_config(ndim, periodic_y)


def _random_fields(mesh, ndim, rng):
    return {n: rng.standard_normal(mesh.shape(Field(c)))
            for c, n in enumerate(("u", "v", "w")[:ndim])}


@pytest.mark.parametrize("chunked", [False, True], ids=["one", "chunks8"])
@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_windowed_engine_matches_jax(name, chunked, jx):
    ndim, periodic_y, kernel, cfg = _engine_case(name)
    jmesh, tmesh = jx.mesh.StaggeredMesh(cfg), tm.StaggeredMesh(cfg)
    jnp = jx.jnp
    X = _points(ndim, periodic_y)
    jd = jx.interp.WindowedDeltaOp(jmesh, kernel, jnp.float64)
    td = tinterp.WindowedDeltaOp(tmesh, kernel, **F64)
    if chunked:
        td._chunk_budget = 1  # chunks of 8 points: 23 = 8 + 8 + 7
    jwin = jd.windows(jnp.asarray(X))
    twin = td.windows(torch.as_tensor(X))
    for c in range(ndim):
        assert td._chunk_size(twin[c]) == (8 if chunked else 1 << 16)
        for d in range(ndim):
            np.testing.assert_array_equal(twin[c]["idx"][d].numpy(),
                                          np.asarray(jwin[c]["idx"][d]))
            assert twin[c]["sd"][d].shape == (X.shape[0], td.half * 2 + 1)
            for key in ("sd", "sv"):
                _close(twin[c][key][d], jwin[c][key][d], 1e-12)
            _close(torch.sum(twin[c]["sd"][d] * twin[c]["sv"][d], dim=1),
                   jnp.sum(jwin[c]["sd"][d] * jwin[c]["sv"][d], axis=1),
                   1e-13)
    rng = np.random.default_rng(7)
    q = _random_fields(jmesh, ndim, rng)
    _close(td.interpolate({k: torch.as_tensor(v) for k, v in q.items()},
                          twin),
           jd.interpolate({k: jnp.asarray(v) for k, v in q.items()}, jwin),
           1e-12)
    f = rng.standard_normal((X.shape[0], ndim))
    got = td.spread(torch.as_tensor(f), twin)
    want = jd.spread(jnp.asarray(f), jwin)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], 1e-12)


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_windowed_engine_matches_factor_engine(name):
    """Two layouts of one operator (JAX tests/test_ibm.py:470-501, 546-):
    E and H to 1e-12, the banded sums to 1e-13."""
    ndim, periodic_y, kernel, cfg = _engine_case(name)
    tmesh = tm.StaggeredMesh(cfg)
    X = torch.as_tensor(_points(ndim, periodic_y, seed=11))
    a = tinterp.make_delta_op(tmesh, kernel, engine="factor", **F64)
    b = tinterp.make_delta_op(tmesh, kernel, engine="windowed", **F64)
    assert not a.windowed and b.windowed
    wa, wb = a.windows(X), b.windows(X)
    rng = np.random.default_rng(8)
    q = {k: torch.as_tensor(v)
         for k, v in _random_fields(tmesh, ndim, rng).items()}
    _close(b.interpolate(q, wb), a.interpolate(q, wa), 1e-12)
    f = torch.as_tensor(rng.standard_normal((X.shape[0], ndim)))
    ha, hb = a.spread(f, wa), b.spread(f, wb)
    for k in ha:
        _close(hb[k], ha[k], 1e-12)
    for c in range(ndim):
        for d in range(ndim):
            _close(torch.sum(wb[c]["sd"][d] * wb[c]["sv"][d], dim=1),
                   torch.sum(wa[c]["sd"][d] * wa[c]["sv"][d], dim=1), 1e-13)


def test_windowed_auto_threshold(jx):
    """``auto`` takes the same engine as the JAX package on each side of
    the threshold (JAX tests/test_ibm.py:534)."""
    cfg = _mesh_config(2, False)
    tmesh, jmesh = tm.StaggeredMesh(cfg), jx.mesh.StaggeredMesh(cfg)
    assert tinterp.WINDOWED_THRESHOLD == jx.interp.WINDOWED_THRESHOLD == 16384
    for n in (100, tinterp.WINDOWED_THRESHOLD, tinterp.WINDOWED_THRESHOLD + 1):
        t = tinterp.make_delta_op(tmesh, n_pts=n, **F64)
        j = jx.interp.make_delta_op(jmesh, n_pts=n)
        assert t.windowed == j.windowed == (n > tinterp.WINDOWED_THRESHOLD)
        assert isinstance(t, tinterp.WindowedDeltaOp) == t.windowed
    with pytest.raises(ValueError, match="unknown delta engine"):
        tinterp.make_delta_op(tmesh, engine="sparse", **F64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_windowed_matches_factor_engine(dtype):
    """On the card: the windowed engine's E and H against the factor
    engine's (3D, chunks of 8 points and one chunk)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ndim, periodic_y, kernel, cfg = _engine_case("3d_yperiodic_peskin")
    tmesh = tm.StaggeredMesh(cfg)
    kw = dict(dtype=dtype, device="cuda")
    X = torch.as_tensor(_points(ndim, periodic_y), **kw)
    a = tinterp.make_delta_op(tmesh, kernel, engine="factor", **kw)
    rng = np.random.default_rng(9)
    q = {k: torch.as_tensor(v, **kw)
         for k, v in _random_fields(tmesh, ndim, rng).items()}
    f = torch.as_tensor(rng.standard_normal((X.shape[0], ndim)), **kw)
    wa = a.windows(X)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for budget in (1, tinterp.WindowedDeltaOp._chunk_budget):
        b = tinterp.make_delta_op(tmesh, kernel, engine="windowed", **kw)
        b._chunk_budget = budget
        wb = b.windows(X)
        _close(b.interpolate(q, wb).cpu(), a.interpolate(q, wa).cpu(), tol)
        ha, hb = a.spread(f, wa), b.spread(f, wb)
        for k in ha:
            _close(hb[k].cpu(), ha[k].cpu(), tol)


# ----------------------------------------------------------------------
# solver runs through the Krylov force solve and the windowed gates

TIGHT = {"velocitySolver": {"type": "CPU", "atol": 1e-12},
         "poissonSolver": {"type": "CPU", "atol": 1e-12},
         "forcesSolver": {"type": "CPU", "atol": 1e-12, "max_it": 1000}}
NSTEPS = 3

#: name -> (case, port class, parameters)
RUNS = {
    "decoupled_windowed": ("cylinder", DecoupledIBPMSolver,
                           {"deltaEngine": "windowed"}),
    "decoupled_dense_false": (
        "cylinder", DecoupledIBPMSolver,
        {"forcesSolver": dict(TIGHT["forcesSolver"], dense=False)}),
    "decoupled_bn2": ("cylinder", DecoupledIBPMSolver, {"BN": 2}),
    "decoupled_bn3": ("cylinder", DecoupledIBPMSolver, {"BN": 3}),
    "ibpm_windowed": ("channel", IBPMSolver, {"deltaEngine": "windowed"}),
    "moving_windowed": ("moving", RigidKinematicsSolver,
                        {"deltaEngine": "windowed"}),
}


def _case(jx, name):
    """(config maker, JAX class, stat keys) of a run."""
    case = RUNS[name][0]
    if case == "cylinder":
        return jx.tdec.config, jx.Dec, jx.tdec.STAT_KEYS
    if case == "moving":
        return jx.trk.config, jx.RK, jx.tdec.STAT_KEYS

    def channel(tmp_path, tag, **params):
        # the coupled IBPM's 30^2 channel (tests/test_ibm.py:ib_config)
        d = tmp_path / tag
        d.mkdir()
        return jx.tibpm.ib_config(d, n=30, nt=NSTEPS,
                                  solver_extra=dict(params, dtype="float64"))

    return channel, jx.IBPM, jx.tibpm.KEYS


def _compared(jx, state):
    if isinstance(state["p"], torch.Tensor):
        state = state_to_numpy({k: state[k] for k in ("q", "p", "f")})
    state = jx.jax.device_get(state)
    return dict(state["q"], p=state["p"]), {"f": state["f"]}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_krylov_force_paths_match_jax(name, tmp_path, monkeypatch, jx):
    _, port_cls, params = RUNS[name]
    make, jax_cls, keys = _case(jx, name)
    params = dict(TIGHT, **params)
    branches = jx.trk.record_branches(monkeypatch)
    jsolver = jax_cls(make(tmp_path, "jax", **params))
    mg = getattr(jsolver, "poisson_mg", None)
    if mg is not None:
        # the JAX V-cycle as on its chip (the Pallas sweep in interpret
        # mode), as tests/test_torch_mgcg.py runs it
        mg.use_pcr = True
        mg._pallas_interpret = True
    state, stats = jsolver.state, []
    for _ in range(NSTEPS):
        state, s = jsolver._step_fn(state)
        stats.append(jx.tdec.host_stats(s, keys))
    jsolver.close()

    port = port_cls(make(tmp_path, "port", **params), device="cpu")
    assert port.delta.windowed == jsolver.delta.windowed
    assert port.delta.windowed == (params.get("deltaEngine") == "windowed")
    if hasattr(port, "_dense_forces"):
        assert not port._dense_forces(port._fopts)
    for _ in range(NSTEPS):
        port.advance()
    port.close()
    got = [{k: h[k] for k in keys} for h in port.stats_history]
    assert got == stats
    if "f_iters" in keys:
        assert all(s["f_iters"] > 0 for s in stats)  # Krylov iterates
    if name == "moving_windowed":
        # the Krylov path in both packages: no dense fallback ran
        assert port.fallbacks == 0 and branches == []
    gf, gforce = _compared(jx, port.state)
    wf, wforce = _compared(jx, state)
    jx.tdec.assert_fields_close(gf, wf, 1e-10)
    jx.tdec.assert_fields_close(gforce, wforce, 1e-8)
