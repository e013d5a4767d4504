"""stepsPerDispatch in the port: k steps a host round trip.

The twins of ``tests/test_chunked.py`` through the port, against the
port's single steps at tolerance 0 and against the JAX package's own
chunked runs (``lax.scan``): the 16^2 cavity (12 steps, k = 4; 1e-12 in
float64), the chunk sequence at nsave 5 with k = 4 ([4, 1, 4, 1], both
snapshots), the decoupled cylinder's forces log (k = 4).

The loops (``linalg/loops.py``): the guarded driver (capped copies of
the body under ``if bool(pred):``, the CPU twin of the graph's IF nodes)
equals the host driver bit for bit for cg, bicgstab and the FDM
refinement, and the JAX package's while_loops in float64; a cap below the
iterations needed sets the overflow flag and equals the host driver cut
at that many iterations; ``max_it`` reached leaves converged false.

The chunk engine (``solvers/chunk.py``) on the CPU: a chunk forced to
overflow (caps 1) equals the single steps, counts ``chunk_overflows`` and
doubles the caps; a divergence inside a chunk aborts at the flush naming
its step (as JAX's does); the moving body (both branches of the force
solve, ``fallbacks`` equal), the coupled IBPM, the pinned pressure and
MG-CG (float32, and the bfloat16 V-cycle) chunked equal their single
steps at tolerance 0; a windowed moving body (walled and y-periodic)
chunked equals its single steps and the JAX package's chunked run; the
launches the engine reconstructs from its capture pass and the rows
equal the wrappers' calls, and those the stats imply.

Card tests (``cuda``; skipped without a card, and importing no JAX):
graph replays against the host driver at tolerance 0 on the 32^2
cylinder and the 16^3 TGV, a skipped IF body leaves the carries as they
were, and the replays of a chunk make no host sync under
``torch.cuda.set_sync_debug_mode("error")``.
"""

import numpy as np
import pytest
import torch

from __graft_entry__ import _cavity_config, _cylinder_config
from petibm_tpu_torch.linalg import krylov, loops
from petibm_tpu_torch.linalg.krylov import SolverDivergedError
from petibm_tpu_torch.operators import cuda_stencil as cs
from petibm_tpu_torch.solvers import chunk
from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver
from petibm_tpu_torch.solvers.ibpm import IBPMSolver
from petibm_tpu_torch.solvers.navierstokes import NavierStokesSolver
from petibm_tpu_torch.solvers.rigidkinematics import RigidKinematicsSolver

torch.set_num_threads(2)

PI = 3.141592653589793


def _dirs(tmp_path, name):
    d = tmp_path / name
    (d / "output").mkdir(parents=True)
    (d / "logs").mkdir()
    return d


def cylinder(tmp_path, name, dtype="float64", **params):
    cfg = _cylinder_config(32, str(_dirs(tmp_path, name)))
    cfg["parameters"].update(dtype=dtype, **params)
    return cfg


def cavity(tmp_path, name, dtype="float64", **params):
    cfg = _cavity_config(16, str(_dirs(tmp_path, name)))
    cfg["parameters"].update(dtype=dtype, **params)
    return cfg


def tgv3d(tmp_path, name, dtype="float64", n=16, **params):
    """The 16^3 TGV of tests/test_torch_tgv3d.py (BiCGStab + Jacobi
    velocity, FDM pressure)."""
    d = _dirs(tmp_path, name)
    solver = {"type": "CPU", "atol": 1e-6, "rtol": 0.0}
    return {
        "directory": str(d), "output": str(d / "output"),
        "logs": str(d / "logs"),
        "mesh": [{"direction": ax, "start": -PI, "subDomains": [
            {"end": PI, "cells": n, "stretchRatio": 1.0}]} for ax in "xyz"],
        "flow": {"nu": 0.000625,
                 "initialVelocity": ["sin(x) * cos(y) * cos(z)",
                                     "- cos(x) * sin(y) * cos(z)", "0"],
                 "initialPressure":
                     "(cos(2*x) + cos(2*y)) * (cos(2*z) + 2) / 16",
                 "boundaryConditions": [
                     {"location": ax + side,
                      **{f: ["PERIODIC", 0.0] for f in "uvw"}}
                     for ax in "xyz" for side in ("Minus", "Plus")]},
        "parameters": dict({
            "dt": 0.05, "nt": 8, "nsave": 100, "nrestart": 100,
            "dtype": dtype, "fdm": {"velocity": False},
            "convection": "ADAMS_BASHFORTH_2", "diffusion": "CRANK_NICOLSON",
            "velocitySolver": dict(solver, kspType="bicgstab"),
            "poissonSolver": dict(solver)}, **params),
    }


def run(cls, cfg, device="cpu"):
    solver = cls(cfg, device=device)
    solver.run()
    solver.close()
    return solver


def leaves(state) -> dict:
    """The state's tensors by path, on the host."""
    flat, _ = torch.utils._pytree.tree_flatten_with_path(state)
    return {torch.utils._pytree.keystr(p): t.cpu() for p, t in flat}


def assert_same_run(a, b):
    """Tolerance 0: every state tensor and every step's stats."""
    la, lb = leaves(a.state), leaves(b.state)
    assert la.keys() == lb.keys()
    for key in la:
        assert torch.equal(la[key], lb[key]), key
    assert a.stats_history == b.stats_history


def chunked_pair(tmp_path, cls, make, k=4, nt=8, **params):
    single = run(cls, make(tmp_path, "single", nt=nt, nsave=nt,
                           nrestart=nt, **params))
    chunked = run(cls, make(tmp_path, "chunked", nt=nt, nsave=nt,
                            nrestart=nt, stepsPerDispatch=k, **params))
    return single, chunked


# ----------------------------------------------------------------------
# the twins of tests/test_chunked.py

def test_cavity_chunked_matches_single(tmp_path):
    from petibm_tpu.solvers.navierstokes import (
        NavierStokesSolver as JaxSolver)
    from test_parallel import cavity_config

    runs = {}
    for name, params in (("single", {}), ("chunked",
                                          {"stepsPerDispatch": 4})):
        d = tmp_path / name
        d.mkdir()
        cfg = cavity_config(str(d))
        cfg["parameters"].update(nt=12, nsave=6, nrestart=12,
                                 dtype="float64", **params)
        runs[name] = run(NavierStokesSolver, cfg)
    sa, sb = runs["single"], runs["chunked"]
    assert sb._chunk is not None and sb.chunk_overflows == 0
    assert_same_run(sa, sb)
    la = (tmp_path / "single" / "output" / "iterations-0.txt").read_text()
    lb = (tmp_path / "chunked" / "output" / "iterations-0.txt").read_text()
    assert la == lb and len(la.splitlines()) == 12

    d = tmp_path / "jax"
    d.mkdir()
    cfg = cavity_config(str(d))
    cfg["parameters"].update(nt=12, nsave=6, nrestart=12, dtype="float64",
                             stepsPerDispatch=4)
    sj = JaxSolver(cfg)
    sj.run()
    sj.close()
    assert sj._chunk_fn is not None
    for key in ("u", "v"):
        np.testing.assert_allclose(sb.state["q"][key].numpy(),
                                   np.asarray(sj.state["q"][key]),
                                   rtol=0, atol=1e-12)
    np.testing.assert_allclose(sb.state["p"].numpy(),
                               np.asarray(sj.state["p"]), rtol=0, atol=1e-12)
    lj = (d / "output" / "iterations-0.txt").read_text().splitlines()
    for rj, rb in zip(lj, lb.splitlines()):
        # the step and every iteration count
        cj, cb = rj.split("\t"), rb.split("\t")
        assert cj[:1] + cj[1::2] == cb[:1] + cb[1::2]


def test_chunk_respects_host_event_boundaries(tmp_path):
    """nsave=5 with k=4: chunks never cross a save point, so the sequence
    is 4,1,4,1 and both snapshots exist (JAX's test, through the port)."""
    pytest.importorskip("h5py")
    d = tmp_path / "case"
    cfg = cavity(tmp_path, "case", nt=10, nsave=5, nrestart=10,
                 stepsPerDispatch=4)
    s = NavierStokesSolver(cfg, device="cpu")
    seen = []
    orig_chunk, orig_single = s.advance_chunk, s.advance
    s.advance_chunk = lambda: (seen.append(s.steps_per_dispatch),
                               orig_chunk())[1]
    s.advance = lambda: (seen.append(1), orig_single())[1]
    s.run()
    s.close()
    assert seen == [4, 1, 4, 1]
    assert (d / "output" / "0000005.h5").exists()
    assert (d / "output" / "0000010.h5").exists()


def test_decoupledibpm_chunked_forces_log(tmp_path):
    from petibm_tpu.solvers.decoupledibpm import (
        DecoupledIBPMSolver as JaxSolver)

    single, chunked = chunked_pair(tmp_path, DecoupledIBPMSolver, cylinder)
    assert_same_run(single, chunked)
    cfg = cylinder(tmp_path, "jax", nt=8, nsave=8, nrestart=8,
                   stepsPerDispatch=4)
    sj = JaxSolver(cfg)
    sj.run()
    sj.close()
    np.testing.assert_allclose(chunked.state["f"].numpy(),
                               np.asarray(sj.state["f"]), rtol=0,
                               atol=1e-10)
    logs = [(tmp_path / name / "output" / "forces-0.txt").read_text()
            .splitlines() for name in ("single", "chunked", "jax")]
    assert len(logs[0]) == len(logs[1]) == len(logs[2]) == 8
    for ra, rb, rj in zip(*logs):
        va, vb, vj = ([float(x) for x in r.split("\t")] for r in (ra, rb, rj))
        np.testing.assert_allclose(vb, va, rtol=0, atol=1e-10)
        np.testing.assert_allclose(vb, vj, rtol=0, atol=1e-10)


# ----------------------------------------------------------------------
# the loops: the guarded driver against the host driver and JAX

LOOP_CASES = {
    # name: (operator, solve, opts)
    "cg": ("poisson", "cg", {"atol": 1e-8, "rtol": 1e-8}),
    "bicgstab": ("momentum", "bicgstab", {"atol": 1e-9}),
    "cg_maxiter": ("momentum", "cg", {"atol": 1e-30, "max_it": 3}),
    "refine": ("poisson", "refine", {"atol": 1e-10}),
}


def _loop_solvers(which, method, opts):
    """The port's and the JAX package's solve of one case: (port solve,
    JAX solve, b, x0), the refinement against a scaled FDM inverse."""
    import jax.numpy as jnp

    from petibm_tpu.linalg import fdm as jfdm
    from petibm_tpu.linalg.krylov import make_solver as jmake
    from petibm_tpu_torch.linalg import fdm as tfdm
    from test_torch_krylov import _operators, _rng_fields

    (jA, tA), (jP, tP), mesh = _operators("2d_walled")
    q, p = _rng_fields(mesh, seed=1)
    jop, top, b = (jA, tA, q) if which == "momentum" else (jP, tP, p)
    opts = dict({"type": method, "rtol": 0.0}, **opts)
    if method != "refine":
        return (krylov.make_solver(top, opts), jmake(jop, opts), b,
                np.zeros_like(b) if which == "poisson"
                else {k: 0.1 * v for k, v in b.items()})
    # the pressure's FDM pseudo-inverse scaled by 0.7: a few passes
    jinv = jfdm.FastDiagPoisson(mesh.dxp, [False, False], dtype=jnp.float64,
                                scale=0.01)
    tinv = tfdm.FastDiagPoisson(mesh.dxp, [False, False],
                                dtype=torch.float64, device="cpu",
                                scale=0.01)

    class J:
        @staticmethod
        def solve(r):
            return 0.7 * jinv.solve(r)

    class T:
        @staticmethod
        def solve(r):
            return 0.7 * tinv.solve(r)

    return (tfdm.make_fdm_solver(T, tP, opts),
            jfdm.make_fdm_solver(J, jP, opts), b, np.zeros_like(b))


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: torch.as_tensor(v) for k, v in tree.items()}
    return torch.as_tensor(tree)


def _guarded(solve, b, x0, cap):
    driver = loops.GuardedDriver([cap], loops.cpu_guard)
    with loops.use(driver):
        res = solve(_tensors(b), _tensors(x0))
    return res, driver.sites[0]


def _assert_results_equal(a, b):
    for key in ("iters", "residual", "converged"):
        assert torch.equal(getattr(a, key), getattr(b, key)), key
    xa = a.x if isinstance(a.x, dict) else {"x": a.x}
    xb = b.x if isinstance(b.x, dict) else {"x": b.x}
    for key in xa:
        assert torch.equal(xa[key], xb[key]), key


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_guarded_loop_matches_host_and_jax(case):
    import jax

    which, method, opts = LOOP_CASES[case]
    tsolve, jsolve, b, x0 = _loop_solvers(which, method, opts)
    host = tsolve(_tensors(b), _tensors(x0))
    n = int(host.iters)
    maxiter = int(opts.get("max_it", 10000))
    # caps at, above and (where the loop runs) below what it needs
    guarded, site = _guarded(tsolve, b, x0, n)
    assert not bool(site.overflow) and int(guarded.iters) == n
    _assert_results_equal(guarded, host)
    guarded, site = _guarded(tsolve, b, x0, n + 3)
    assert not bool(site.overflow)
    _assert_results_equal(guarded, host)
    if n > 1 and n < maxiter:
        cut, site = _guarded(tsolve, b, x0, n - 1)
        assert bool(site.overflow) and int(cut.iters) == n - 1
        short = dict(opts, max_it=n - 1)
        want = _loop_solvers(which, method, short)[0](_tensors(b),
                                                      _tensors(x0))
        _assert_results_equal(cut, want)
    if "max_it" in opts:
        assert n == maxiter and not bool(host.converged)
    else:
        assert bool(host.converged) and n > 0
    # the JAX package's while_loop, float64
    want = jax.device_get(jsolve(jax.tree_util.tree_map(np.asarray, b),
                                 jax.tree_util.tree_map(np.asarray, x0)))
    assert int(host.iters) == int(want.iters)
    assert bool(host.converged) == bool(want.converged)
    assert float(host.residual) == pytest.approx(float(want.residual),
                                                 rel=1e-4)
    gx = host.x if isinstance(host.x, dict) else {"x": host.x}
    wx = want.x if isinstance(want.x, dict) else {"x": want.x}
    for key in wx:
        w = np.asarray(wx[key])
        assert np.abs(gx[key].numpy() - w).max() <= 1e-10 * np.abs(w).max()


def test_guarded_cond_runs_where_pred_holds():
    x = torch.zeros(3, dtype=torch.float64)
    for flag, want in ((False, 0.0), (True, 1.0), (False, 1.0)):
        driver = loops.GuardedDriver([1], loops.cpu_guard)
        with loops.use(driver):
            loops.cond(torch.tensor(flag), lambda: x.add_(1.0), (x,))
        assert [s.kind for s in driver.sites] == ["cond"]
        assert torch.equal(x, torch.full((3,), want, dtype=torch.float64))


# ----------------------------------------------------------------------
# the chunk engine on the CPU

def _force_caps(monkeypatch, cap):
    """Every loop's cap set to ``cap`` at the first chunk's capture."""
    real = chunk.ChunkRunner.prepare

    def prepare(self):
        real(self)
        self.caps = [1 if s.kind == "cond" else cap for s in self.sites]
        self.capture()

    monkeypatch.setattr(chunk.ChunkRunner, "prepare", prepare)


def test_overflow_reruns_and_recaptures(tmp_path, monkeypatch):
    """MG-CG needs several CG iterations a step: with every cap 1 the
    first chunk overflows, its steps rerun through the host driver, the
    CG cap doubles and the step is captured again; the run equals the
    single steps at tolerance 0."""
    _force_caps(monkeypatch, 1)
    single, chunked = chunked_pair(tmp_path, DecoupledIBPMSolver, cylinder,
                                   nt=12, fdm=False)
    assert_same_run(single, chunked)
    assert chunked.chunk_overflows >= 1
    sites = chunked._chunk.sites
    # the sites: the velocity CG, the force refinement, the pressure
    # MG-CG (its 8-11 iterations a step overflow every chunk here)
    assert [s.kind for s in sites] == ["cg", "refine", "cg"]
    assert chunked._chunk.caps[2] == 2 ** chunked.chunk_overflows
    # each of the three chunks overflowed: caps 1, 2 and 4 against 8-11
    assert chunked.chunk_overflows == 3


def test_divergence_in_chunk_names_its_step(tmp_path):
    """No refinement pass allowed for the velocity: step 2 needs one, so
    the run aborts at the flush after the chunk and names step 2, as the
    JAX package's chunked run does."""
    from petibm_tpu.linalg import SolverDivergedError as JaxDivergedError
    from petibm_tpu.solvers.decoupledibpm import (
        DecoupledIBPMSolver as JaxSolver)

    vel = {"type": "CPU", "max_it": 0, "atol": 1e-12, "rtol": 0.0}
    msgs = []
    for name, cls, kw in (("port", DecoupledIBPMSolver, {"device": "cpu"}),
                          ("jax", JaxSolver, {})):
        cfg = cylinder(tmp_path, name, nt=4, nsave=4, nrestart=4,
                       stepsPerDispatch=4, velocitySolver=vel)
        solver = cls(cfg, **kw)
        with pytest.raises((SolverDivergedError,
                            JaxDivergedError)) as err:
            solver.run()
        msgs.append(str(err.value))
        if name == "port":
            assert solver.ite == 4 and solver._chunk is not None
    assert "velocity solver diverged at time step 2:" in msgs[0]
    assert msgs[0].split(":")[0] == msgs[1].split(":")[0]


def moving(tmp_path, name, dtype="float64", **params):
    cfg = cylinder(tmp_path, name, dtype=dtype, **params)
    cfg["bodies"][0]["kinematics"] = {"type": "oscillation", "f": 1.0,
                                      "D": 1.0, "KC": 2.0}
    return cfg


def ibpm(tmp_path, name, dtype="float64", **params):
    from test_ibm import ib_config

    d = tmp_path / name
    d.mkdir()
    cfg = ib_config(d, n=30, nt=8, solver_extra={"dtype": dtype})
    cfg["parameters"].update(params)
    return cfg


SOLVER_CASES = {
    # name: (class, config, parameters)
    "moving": (RigidKinematicsSolver, moving, {}),
    "ibpm": (IBPMSolver, ibpm, {}),
    "pinned": (NavierStokesSolver, cavity, {"poissonSolver": {
        "type": "GPU", "atol": 1e-10}}),
    "mgcg_f32": (DecoupledIBPMSolver, cylinder, {"fdm": False,
                                                 "dtype": "float32"}),
    "mgcg_bf16": (DecoupledIBPMSolver, cylinder, {
        "fdm": False, "mg": {"dtype": "bfloat16"}}),
}


@pytest.mark.parametrize("case", sorted(SOLVER_CASES))
def test_more_solvers_chunked_equal_single(case, tmp_path):
    cls, make, params = SOLVER_CASES[case]
    single, chunked = chunked_pair(tmp_path, cls, make, **params)
    assert chunked._chunk is not None
    assert_same_run(single, chunked)
    if case != "moving":
        assert chunked.chunk_overflows == 0
    else:
        # both branches of the force solve ran, at the same steps
        assert 0 < chunked.fallbacks == single.fallbacks < 8
        assert "cond" in [s.kind for s in chunked._chunk.sites]


#: the windowed moving cylinders: the solves to 1e-12, so that the two
#: packages part by rounding alone
TIGHT = {"velocitySolver": {"type": "CPU", "atol": 1e-12},
         "poissonSolver": {"type": "CPU", "atol": 1e-12},
         "forcesSolver": {"type": "CPU", "atol": 1e-12, "max_it": 1000}}


def moving_windowed(tmp_path, name, yperiodic=False, **params):
    cfg = moving(tmp_path, name, deltaEngine="windowed", **TIGHT, **params)
    if yperiodic:
        for bc in cfg["flow"]["boundaryConditions"]:
            if bc["location"] in ("yMinus", "yPlus"):
                bc["u"] = ["PERIODIC", 0.0]
                bc["v"] = ["PERIODIC", 0.0]
    return cfg


@pytest.mark.parametrize("yperiodic", [False, True])
def test_windowed_moving_body_chunked(yperiodic, tmp_path):
    """A moving body on the windowed delta engine in chunks of 4 (its
    window box the whole grid, read by no step): the 32^2 oscillating
    cylinder, walled and y-periodic, equals its single steps bit for bit
    and is within 1e-12 of its fields' maxima of the JAX package's
    chunked run (``lax.scan``), every ``_iters``/``_ok`` stat (and
    ``fallback`` where the force solve has one) equal per step."""
    import jax

    from petibm_tpu.solvers.rigidkinematics import (
        RigidKinematicsSolver as JaxSolver)

    def make(tmp_path, name, **params):
        return moving_windowed(tmp_path, name, yperiodic, **params)

    single, chunked = chunked_pair(tmp_path, RigidKinematicsSolver, make)
    assert chunked.delta.windowed and chunked._chunk is not None
    assert chunked.chunk_overflows == 0
    assert_same_run(single, chunked)
    win = chunked._windows(chunked.state)[0]
    assert all(w["lo"] == [0, 0] and w["hi"] == chunked.delta.n[c]
               for c, w in win.items())

    jsolver = JaxSolver(make(tmp_path, "jax", nt=8, nsave=8, nrestart=8,
                             stepsPerDispatch=4))
    assert jsolver.delta.windowed and jsolver._chunk_fn is not None
    state, stats = jsolver.state, []
    for _ in range(2):
        state, s = jsolver._chunk_fn(state)
        s = jax.device_get(s)
        stats += [{k: v[j] for k, v in s.items() if np.ndim(v) == 1}
                  for j in range(4)]
    state = jax.device_get(state)
    jsolver.close()
    want = dict(state["q"], p=state["p"], f=state["f"])
    got = dict(chunked.state["q"], p=chunked.state["p"],
               f=chunked.state["f"])
    for key, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=1e-12 * np.abs(w).max(), err_msg=key)
    keys = [k for k in stats[0]
            if k.endswith(("_iters", "_ok")) or k == "fallback"]
    assert "f_iters" in keys
    for key in keys:
        assert [h[key] for h in chunked.stats_history] == \
            [s[key].item() for s in stats], key


def _counting(monkeypatch, module, name):
    """Wrap the kernel wrapper ``module.name`` so that every call counts
    in its ``launches`` (the CPU twins count nothing)."""
    real = getattr(module, name)

    def counted(*args, **kwargs):
        counted.launches += 1
        return real(*args, **kwargs)

    counted.launches = 0
    counted.scaled_launches = getattr(real, "scaled_launches", 0)
    monkeypatch.setattr(module, name, counted)
    return counted


@pytest.mark.parametrize("fdm", [True, False])
def test_launch_reconstruction_equals_calls(fdm, tmp_path, monkeypatch):
    """The launches ``chip_smoke.py`` reconstructs from a chunk's stats
    equal the wrappers' calls in the chunk (the guarded step's CPU twin,
    which runs the bodies a replay runs): K1 2 + p_iters a step (FDM), or
    2 per V-cycle and a V-cycle per CG iteration and one more (MG-CG),
    with K4/K5 at each V-cycle's sweeps."""
    from petibm_tpu_torch.linalg import cuda_sweep, mg

    k1 = _counting(monkeypatch, cs, "poisson_apply_separable")
    sweep = _counting(monkeypatch, cuda_sweep, "fused_sweep")
    monkeypatch.setattr(mg, "fused_sweep", sweep)
    cfg = cylinder(tmp_path, "run", nt=8, nsave=8, nrestart=8,
                   stepsPerDispatch=4, fdm=fdm)
    solver = DecoupledIBPMSolver(cfg, device="cpu")
    solver.advance_chunk()        # warm-up and one chunk
    before = (k1.launches, sweep.launches)
    solver.advance_chunk()
    calls = {"K1": k1.launches - before[0],
             "K4/K5": sweep.launches - before[1]}
    hist = solver.stats_history[4:]
    assert [h["ite"] for h in hist] == [5, 6, 7, 8]
    if fdm:
        assert calls == {"K1": sum(2 + h["p_iters"] for h in hist),
                         "K4/K5": 0}
    else:
        vcycles = sum(1 + h["p_iters"] for h in hist)
        assert calls == {
            "K1": 2 * vcycles,
            "K4/K5": solver.poisson_mg.sweeps_per_vcycle() * vcycles}
    assert solver.chunk_overflows == 0
    solver.close()


# ----------------------------------------------------------------------
# on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def pinned_cylinder(tmp_path, name, **params):
    """The 32^2 cylinder with the pinned pressure (its FDM solve by FFT)."""
    return cylinder(tmp_path, name, poissonSolver={"type": "GPU",
                                                   "max_it": 100}, **params)


CARD_CASES = {"cylinder32": (DecoupledIBPMSolver, cylinder),
              "cylinder32_pinned": (DecoupledIBPMSolver, pinned_cylinder),
              "tgv16": (NavierStokesSolver, tgv3d)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_replay_equals_host_driver(case, dtype, tmp_path):
    """k = 4 graph replays against the single steps through the host
    driver, on the card: every state tensor and every stat equal."""
    _card()
    cls, make = CARD_CASES[case]
    runs = []
    for name, params in (("single", {}), ("chunked",
                                          {"stepsPerDispatch": 4})):
        cfg = make(tmp_path, name, dtype=dtype, nt=8, nsave=8, nrestart=8,
                   **params)
        runs.append(run(cls, cfg, device="cuda"))
    assert runs[1]._chunk.graph is not None
    assert runs[1]._chunk.info["nodes"] > runs[1]._chunk.info["top_nodes"]
    assert_same_run(*runs)


@pytest.mark.cuda
def test_cuda_skipped_if_body_keeps_carries():
    """An IF node's body runs only where its predicate holds at replay;
    a skipped body leaves the carries as they were."""
    _card()
    from petibm_tpu_torch.utils import graphs

    x = torch.zeros(4, device="cuda")
    pred = torch.zeros((), dtype=torch.bool, device="cuda")
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    pool = torch.cuda.graph_pool_handle()
    guard = graphs.IfNodes("cuda")
    with graphs.capture(graph, pool, stream):
        with guard(pred):
            y = x + 1.0       # a body temporary, from the body's pool
            x.copy_(y * 3.0)
    for flag, want in ((False, 0.0), (True, 3.0), (False, 3.0),
                       (True, 12.0)):
        pred.fill_(flag)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(x.cpu(), torch.full((4,), want))


@pytest.mark.cuda
def test_cuda_chunk_replays_without_sync(tmp_path):
    """Two chunks: the second replays the captured graph k times under
    set_sync_debug_mode("error") (which the runner sets around its
    replays: a sync raises) and reads the rows once after them."""
    _card()
    cfg = cylinder(tmp_path, "run", dtype="float32", nt=8, nsave=8,
                   nrestart=8, stepsPerDispatch=4)
    solver = DecoupledIBPMSolver(cfg, device="cuda")
    solver.advance_chunk()
    graph = solver._chunk.graph
    solver.advance_chunk()
    assert solver._chunk.graph is graph and solver.chunk_overflows == 0
    assert torch.cuda.get_sync_debug_mode() == 0
    rows = solver._chunk.rows.cpu()
    assert rows.shape[0] == 4 and bool(torch.isfinite(rows).all())
    assert [h["ite"] for h in solver.stats_history] == list(range(1, 9))
    solver.close()



@pytest.mark.cuda
def test_cuda_chunk_counts_launches_on_device(tmp_path):
    """With ``count_on_device`` on, a replayed chunk counts K1's launches
    on the card (2 + p_iters a step), and the delta engine's E (1 a step)
    and H (2 a step), while its wrappers' host counters, and a capture's,
    stay 0."""
    _card()
    from petibm_tpu_torch import _kernels

    cfg = cylinder(tmp_path, "run", dtype="float32", nt=4, nsave=100,
                   nrestart=100, stepsPerDispatch=4)
    solver = DecoupledIBPMSolver(cfg, device="cuda")
    solver.run()                  # warm-up, capture, one chunk
    _kernels.count_on_device("cuda")
    try:
        _kernels.reset_launch_counts()
        solver._chunk.capture()
        solver.nt += 4
        solver.run()
        counts = _kernels.device_launch_counts()
    finally:
        _kernels.count_on_device(None)
    solver._chunk.capture()
    assert all(n == 0 for n in _kernels.launch_counts().values())
    assert solver.chunk_overflows == 0
    hist = solver.stats_history[4:]
    assert counts == dict({k: 0 for k in counts},
                          K1=sum(2 + h["p_iters"] for h in hist),
                          E=len(hist), H=2 * len(hist))
    solver.close()
