"""The 3-axis (dz, dy, dx) mesh, the FDM's contraction core, the z-cut
V-cycle, the windowed delta engine and the probes on a decomposed run of
the port, on CPU processes over gloo, held to the JAX package.

The ranks are processes of this file (``python
test_torch_parallel_3axis.py <job> <rank> <world> <port> <out>``, one
torch thread each).  Three jobs start together when the module's first
test asks for them (``test_torch_parallel.RankJob``); rank 0 of each
publishes what the ranks computed in ``<out>`` as each result is known
(the checks, then each case), and each test waits for the file it reads.
The tests run the JAX package in this process on the same
configurations.  All in float64.

- job ``eight`` ([2, 2, 2]): ``mesh_from_config`` and its errors; the
  scatter/gather round trips, face segments and halos of every field
  (2D grids replicated along "dz"); the FDM's contraction core against
  the single-rank solves on the FDM grids of ``test_torch_parallel.py``
  (FFTs on cut axes among them); the z-cut V-cycle against the
  single-rank one (walled, K5's twin; z-periodic, K7's); the sphere of
  ``tests/test_parallel.py:245-264``, 3 steps.
- job ``two`` ([2, 1, 1]): the layout; the z-cut V-cycle; the sphere
  with ``fdm: false`` (MG-CG, the line-sweep twins called as the stats
  imply, K1-K3's never).
- job ``four``: the layout and the 2D cavity on [2, 1, 2] (replicated
  along "dz"); on [2, 2] the contraction core with ``repartition:
  false`` against the single-rank solves, the cylinder and the cavity
  with ``fdm.repartition: false``, the cylinder with ``deltaEngine:
  windowed`` stationary and moving, and the cavity with a point and a
  volume probe (ASCII files against the JAX single-device run's); which
  FDM core each mesh takes, by its type and by the collectives a step
  makes; the gather bytes of the probes and of a windowed step.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
for path in (REPO, HERE):
    if path not in sys.path:
        sys.path.insert(0, path)

from test_torch_parallel import (FDM_GRIDS, LAYOUT_GRIDS,  # noqa: E402
                                 SHARDING, RankJob, _fdm_checks, _grid,
                                 _layout_checks, cavity_config,
                                 cylinder_config, init_ranks, publish_json,
                                 publish_npz, sphere_config)

#: the jobs' time limit (s from their start): a guard against a hang, at
#: least 4x the jobs' run on an idle machine (CHANGES.md)
TIMEOUT = 200
JOBS = {"eight": 8, "two": 2, "four": 4}
#: the layout checks' meshes, per job
LAYOUT_SHAPES = {"eight": [[2, 2, 2]], "two": [[2, 1, 1]],
                 "four": [[2, 1, 2]]}
VCYCLE_GRIDS = {
    "walls_3d": _grid([("x", 13, 1.05), ("y", 12, 1.0), ("z", 11, 0.97)]),
    "periodic_z_3d": _grid([("x", 12, 1.04), ("y", 10, 1.0),
                            ("z", 12, 1.0)], "z"),
}
#: the cavity's probes: a point probe of u, one of p every other step,
#: a volume probe of p and one of v averaged over two calls (ASCII)
PROBES = [
    {"type": "POINT", "field": "u", "path": "probe-u.txt",
     "loc": [0.5, 0.75]},
    {"type": "POINT", "field": "p", "path": "probe-pp.txt",
     "loc": [0.31, 0.47], "n_monitor": 2},
    {"type": "VOLUME", "field": "p", "viewer": "ascii",
     "path": "probe-p.txt", "box": {"x": [0.0, 1.0], "y": [0.4, 0.6]}},
    {"type": "VOLUME", "field": "v", "viewer": "ascii", "n_sum": 2,
     "path": "probe-v.txt", "box": {"x": [0.2, 0.5], "y": [0.1, 0.9]}},
]


# --- configurations ----------------------------------------------------------
def _norepart(make):
    def build(tmpdir, sharding=None):
        cfg = make(tmpdir, sharding=sharding)
        cfg["parameters"]["fdm"] = {"repartition": False}
        return cfg

    return build


def _windowed(make):
    def build(tmpdir, sharding=None):
        cfg = make(tmpdir, sharding=sharding)
        cfg["parameters"]["deltaEngine"] = "windowed"
        return cfg

    return build


def sphere_mg(tmpdir, sharding=None):
    cfg = sphere_config(tmpdir, sharding=sharding)
    cfg["parameters"]["fdm"] = False
    return cfg


def oscillating(tmpdir, sharding=None):
    """test_torch_parallel_mg.py's oscillating cylinder."""
    cfg = cylinder_config(tmpdir, sharding=sharding)
    cfg["bodies"][0]["kinematics"] = {"type": "oscillation", "f": 0.2,
                                      "D": 0.4, "KC": 2.0}
    return cfg


def cavity_probes(tmpdir, sharding=None):
    cfg = cavity_config(tmpdir, sharding=sharding)
    cfg["parameters"].update(nt=4, nsave=100, nrestart=100)
    cfg["probes"] = [dict(p) for p in PROBES]
    return cfg


NS = "navierstokes.NavierStokesSolver"
DECOUPLED = "decoupledibpm.DecoupledIBPMSolver"
#: name -> (job, mesh shape, config, solver, steps, atol); the JAX
#: package's bounds (tests/test_parallel.py:108-264)
CASES = {
    "sphere_2x2x2": ("eight", [2, 2, 2], sphere_config, DECOUPLED, 3, 1e-9),
    "sphere_mg_2x1x1": ("two", [2, 1, 1], sphere_mg, DECOUPLED, 3, 1e-9),
    "cavity_2x1x2": ("four", [2, 1, 2], cavity_config, NS, 10, 1e-10),
    "cavity_norepart": ("four", [2, 2], _norepart(cavity_config), NS, 10,
                        1e-10),
    "cylinder_norepart": ("four", [2, 2], _norepart(cylinder_config),
                          DECOUPLED, 5, 1e-9),
    "cylinder_windowed": ("four", [2, 2], _windowed(cylinder_config),
                          DECOUPLED, 5, 1e-9),
    "oscillating_windowed": ("four", [2, 2], _windowed(oscillating),
                             "rigidkinematics.RigidKinematicsSolver", 3,
                             1e-9),
    "cavity_probes": ("four", [2, 2], cavity_probes, NS, 4, 1e-10),
}


def _solver_class(name: str, package: str):
    import importlib

    module, cls = name.split(".")
    return getattr(importlib.import_module(f"{package}.solvers.{module}"),
                   cls)


# --- the rank processes ----------------------------------------------------
def _mesh_checks() -> dict:
    """``mesh_from_config`` on an 8-rank group: the 3-axis mesh, its
    row-major ranks, and the JAX package's errors."""
    from petibm_tpu_torch.parallel import mesh_from_config

    m = mesh_from_config(dict(SHARDING, shape=[2, 2, 2]))
    out = {"names": list(m.axis_names), "shape": list(m.shape),
           "coords": [list(m.coord_of(r)) for r in range(8)],
           "rank_at": [m.rank_at(iz, iy, ix) for iz in range(2)
                       for iy in range(2) for ix in range(2)]}
    for key, node in (("bad_product", dict(SHARDING, shape=[2, 2, 3])),
                      ("four_axes", dict(SHARDING, shape=[1, 2, 2, 2])),
                      ("too_many", {"nDevices": 1000})):
        try:
            mesh_from_config(node)
            out[key] = "no error"
        except (ValueError, NotImplementedError) as err:
            out[key] = [type(err).__name__, str(err)]
    return out


def _count_calls() -> dict:
    """Count every kernel wrapper a run reaches (the twins of K1-K7)."""
    from petibm_tpu_torch.linalg import mg as mg_mod
    from petibm_tpu_torch.operators import cuda_stencil as cs

    calls = {}
    for mod, name in ((mg_mod, "fused_sweep"), (mg_mod, "pcr"),
                      (cs, "poisson_apply_separable"),
                      (cs, "zblocked_helmholtz_apply"),
                      (cs, "convection3d_apply")):
        real = getattr(mod, name)
        calls[name] = 0

        def counted(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        setattr(mod, name, counted)
    return calls


def _vcycle_checks(pmesh, calls) -> dict:
    """Each grid's decomposed V-cycle against the single-rank one, with no
    consolidation threshold: the relative error, the decomposed levels,
    this rank's level-0 tensor of each sweep and the line-sweep wrappers
    the decomposed cycle called."""
    from petibm_tpu_torch.linalg.mg import PoissonMG
    from petibm_tpu_torch.mesh import StaggeredMesh
    from petibm_tpu_torch.parallel import Partition
    from petibm_tpu_torch.types import Field

    out = {}
    for gname, cfg in VCYCLE_GRIDS.items():
        mesh = StaggeredMesh(cfg)
        part = Partition(mesh, pmesh)
        b = torch.as_tensor(np.random.default_rng(3).standard_normal(
            mesh.shape(Field.P)))
        kw = dict(dtype=torch.float64, device="cpu", scale=0.01, pre=1,
                  post=1, consolidate_below=0)
        want = PoissonMG(mesh.dxp, mesh.periodic, **kw).preconditioner()(b)
        dec = PoissonMG(mesh.dxp, mesh.periodic, **kw)
        dec.set_mesh(part)
        seen = set()
        smooth = dec.smooth

        def record(lvl, phi, rhs, sweeps, _smooth=smooth):
            if lvl == 0:
                seen.add(tuple(phi.shape))
            return _smooth(lvl, phi, rhs, sweeps)

        dec.smooth = record
        for key in calls:
            calls[key] = 0
        got = part.gather(dec.preconditioner()(part.scatter(b, Field.P)),
                          Field.P)
        out[gname] = {
            "err": float((got - want).abs().max() / want.abs().max()),
            "ndec": len(dec.blocks),
            "z_cut": [lb.cut(2) for lb in dec.blocks],
            "seen": sorted(map(list, seen)),
            "block": list(part.local_shape(Field.P)),
            "calls": {k: calls[k] for k in ("fused_sweep", "pcr")}}
    return out


def _core_name(solver) -> str:
    fdm = getattr(solver, "poisson_fdm", None)
    return type(fdm._core).__name__ if fdm is not None else ""


def _run_case(name, tmpdir, calls) -> dict:
    """The case decomposed on its mesh: its fields gathered, its stats per
    step, this rank's kernel-wrapper calls, its FDM core and the
    collectives of its steps (calls and bytes this rank sent)."""
    from petibm_tpu_torch.convert import state_to_numpy
    from petibm_tpu_torch.parallel import counters, reset_counters
    from petibm_tpu_torch.types import Field

    _, shape, build, cls, steps, _ = CASES[name]
    solver = _solver_class(cls, "petibm_tpu_torch")(
        build(tmpdir, sharding=dict(SHARDING, shape=shape)), device="cpu")
    assert solver.part is not None
    for key in calls:
        calls[key] = 0
    out = {}
    if name == "cavity_probes":
        # the gathers of each monitor call of the probes
        monitor, seen = solver.monitor_probes, []

        def monitored():
            before = dict(counters()["gather"])
            monitor()
            after = counters()["gather"]
            seen.append([after["calls"] - before["calls"],
                         after["bytes"] - before["bytes"]])

        solver.monitor_probes = monitored
        reset_counters()
        solver.run()
        comm = counters()
        stats = [{k: float(v) for k, v in s.items() if k != "ite"}
                 for s in solver.stats_history]
        out["probe_gather"] = np.array(seen)
        state = solver.state
    else:
        state, stats = solver.state, []
        reset_counters()
        for _ in range(steps):
            state, s = solver._step_fn(state)
            stats.append({k: float(v) for k, v in s.items() if k != "f"})
        comm = counters()
    full = state_to_numpy(state, solver.part)
    solver.close()
    out.update({f"q_{k}": v for k, v in full["q"].items()})
    out["p"] = full["p"]
    if "f" in full:
        out["f"] = full["f"]
    for key in stats[0]:
        out[f"stat_{key}"] = np.array([s[key] for s in stats])
    out["comm"] = np.array([[comm[k]["calls"], comm[k]["bytes"]]
                            for k in sorted(comm)])
    out["comm_keys"] = np.array(sorted(comm))
    out["core"] = np.array(_core_name(solver))
    out["calls"] = np.array([calls[k] for k in sorted(calls)])
    mg = getattr(solver, "poisson_mg", None)
    out["sweeps"] = np.array(
        [mg.sweeps_per_vcycle() if mg is not None else -1,
         int(mg is not None and any(mg.levels[0].periodic)),
         len(mg.blocks) if mg is not None else 0])
    out["block"] = np.array(solver.part.local_shape(Field.P))
    return out


def _job(job, rank, out):
    import torch.distributed as dist

    from petibm_tpu_torch.mesh import StaggeredMesh
    from petibm_tpu_torch.parallel import Partition, mesh_from_config

    res = {"layout": {}, "fdm": {}, "vcycle": {}}
    if job == "eight":
        res["mesh"] = _mesh_checks()
    for shape in LAYOUT_SHAPES[job]:
        pm = mesh_from_config(dict(SHARDING, shape=shape))
        tag = "x".join(map(str, shape))
        for gname, cfg in LAYOUT_GRIDS.items():
            mesh = StaggeredMesh(cfg)
            res["layout"][f"{tag}-{gname}"] = _layout_checks(
                Partition(mesh, pm), mesh, seed=7)
    # the contraction core: on [2, 2, 2], and on [2, 2] asked for
    fdm_meshes = {"eight": [([2, 2, 2], True)], "four": [([2, 2], False)],
                  "two": []}[job]
    for shape, repart in fdm_meshes:
        pm = mesh_from_config(dict(SHARDING, shape=shape))
        tag = "x".join(map(str, shape))
        for gname, cfg in FDM_GRIDS.items():
            mesh = StaggeredMesh(cfg)
            part = Partition(mesh, pm)
            for solve, err in _fdm_checks(part, mesh, cfg, seed=11,
                                          repartition=repart).items():
                res["fdm"][f"{tag}-{gname}-{solve}"] = err
    calls = _count_calls()
    if job in ("eight", "two"):
        shape = [2, 2, 2] if job == "eight" else [2, 1, 1]
        res["vcycle"] = _vcycle_checks(
            mesh_from_config(dict(SHARDING, shape=shape)), calls)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, res["vcycle"])
    if rank == 0:
        res["ranks"] = every
        publish_json(out, f"{job}.json", res)
    for name, spec in CASES.items():
        if spec[0] != job:
            continue
        arr = _run_case(name, os.path.join(out, f"{name}-{rank}"), calls)
        dist.all_gather_object(every, {"calls": arr["calls"].tolist(),
                                       "block": arr["block"].tolist(),
                                       "comm": arr["comm"].tolist()})
        if rank == 0:
            arr["ranks"] = np.array(json.dumps(every))
            publish_npz(out, f"{name}.npz", arr)


def _rank_main(argv) -> None:
    import torch.distributed as dist

    job, rank, world, port, out = argv
    init_ranks(int(rank), int(world), int(port))
    _job(job, int(rank), out)
    dist.destroy_process_group()


# --- the tests' side ---------------------------------------------------------
class _Jobs:
    """The three rank jobs (``RankJob``), started together when the
    module's first test asks for them; ``result(job)`` reads a job's
    checks, ``case(name)`` a case's arrays with ``ranks``, every rank's
    calls, block and collectives."""

    def __init__(self, root):
        self.jobs, self.res = {}, {}
        for job, world in JOBS.items():
            (root / job).mkdir()
            self.jobs[job] = RankJob([os.path.abspath(__file__), job], world,
                                     root / job, TIMEOUT)

    def result(self, job: str) -> dict:
        if job not in self.res:
            self.res[job] = self.jobs[job].json(f"{job}.json")
        return self.res[job]

    def case(self, name: str) -> dict:
        got = self.jobs[CASES[name][0]].npz(f"{name}.npz")
        got["ranks"] = json.loads(str(got["ranks"]))
        return got

    def dir(self, job: str):
        return self.jobs[job].out

    def stop(self) -> None:
        for job in self.jobs.values():
            job.stop()


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    job = _Jobs(tmp_path_factory.mktemp("three_axis"))
    yield job
    job.stop()


def test_mesh_from_config_3axis(jobs):
    """``sharding.shape: [2, 2, 2]`` gives the ("dz", "dy", "dx") mesh,
    rank = (iz * dy + iy) * dx + ix; a shape whose product is not the
    group's size, one of 4 entries and more devices than processes are
    the JAX package's ValueErrors."""
    m = jobs.result("eight")["mesh"]
    assert m["names"] == ["dz", "dy", "dx"] and m["shape"] == [2, 2, 2]
    assert m["rank_at"] == list(range(8))
    assert m["coords"] == [[r // 4, (r // 2) % 2, r % 2] for r in range(8)]
    for key in ("bad_product", "four_axes", "too_many"):
        assert m[key][0] == "ValueError", (key, m[key])


@pytest.mark.parametrize("job", sorted(JOBS))
def test_3axis_layout(jobs, job):
    """Every field's scatter -> gather round trip, face segments and halo
    slabs equal the full array's bit for bit, with z cut ([2, 2, 2],
    [2, 1, 1]) and with 2D grids replicated along "dz" ([2, 1, 2])."""
    res = jobs.result(job)
    tags = ["x".join(map(str, s)) for s in LAYOUT_SHAPES[job]]
    assert len(res["layout"]) == len(LAYOUT_GRIDS) * len(tags)
    for key, worst in res["layout"].items():
        assert worst == {"gather": 0.0, "halo": 0.0, "face": 0.0}, key


@pytest.mark.parametrize("job", ["eight", "four"])
def test_contraction_fdm_matches_single(jobs, job):
    """The contraction core's Poisson and Helmholtz solves equal the
    single-rank solves at 1e-12 in float64 (the sums in another order):
    2D stretched and odd, FFTs on z, on x and y, on y alone and on all
    three axes, on [2, 2, 2] and on [2, 2] with ``repartition: false``."""
    errs = jobs.result(job)["fdm"]
    assert len(errs) == 3 + 4 + 3 + 3 + 4
    for name, err in errs.items():
        assert err <= 1e-12, (name, err)


@pytest.mark.parametrize("grid", sorted(VCYCLE_GRIDS))
@pytest.mark.parametrize("job", ["eight", "two"])
def test_zcut_vcycle_matches_single(jobs, job, grid):
    """One V-cycle on z-cut levels ([2, 2, 2], [2, 1, 1]) equals the
    single-rank one to 1e-12 in float64; level 0 and at least one more
    stay decomposed with z cut, every rank sweeps its own block, and the
    sweeps go through K5's twin on the walled grid and K7's on the
    z-periodic one on every rank."""
    res = jobs.result(job)
    for rank, every in enumerate(res["ranks"]):
        ref = every[grid]
        assert ref["err"] <= 1e-12, (rank, ref["err"])
        assert ref["ndec"] >= 2 and all(ref["z_cut"]), ref
        assert ref["block"] in ref["seen"], ref
        periodic = grid.startswith("periodic")
        assert (ref["calls"]["pcr"] > 0) == periodic, ref
        assert (ref["calls"]["fused_sweep"] > 0) != periodic, ref


def _run_jax(name, tmpdir, sharding=None):
    """The JAX package's run of a case (single device unless
    ``sharding``): its state and stats per step, and its output
    directory."""
    import jax

    _, _, build, cls, steps, _ = CASES[name]
    cfg = build(tmpdir, sharding=sharding)
    solver = _solver_class(cls, "petibm_tpu")(cfg)
    if name == "cavity_probes":
        solver.run()
        state = jax.device_get(solver.state)
        # its stats from its iterations log (ite, v_iters, v_res,
        # p_iters, p_res)
        log = np.loadtxt(os.path.join(cfg["output"], "iterations-0.txt"))
        stats = [{"v_iters": row[1], "p_iters": row[3]} for row in log]
    else:
        state, stats = solver.state, []
        for _ in range(steps):
            state, s = solver._step_fn(state)
            s = jax.device_get(s)
            stats.append({k: float(v) for k, v in s.items() if k != "f"})
        state = jax.device_get(state)
    solver.close()
    return state, stats, cfg["output"]


def _implied_calls(got) -> list:
    """The kernel wrappers' calls the stats imply on each rank (sorted by
    name): sweeps_per_vcycle() x V-cycles on K4/K5's or K6/K7's twin;
    K1-K3 off under a mesh."""
    sweeps, periodic, _ = (int(v) for v in got["sweeps"])
    vcycles = int(np.sum(got["stat_p_iters"] + 1)) if sweeps > 0 else 0
    want = {"fused_sweep": 0 if periodic else sweeps * vcycles,
            "pcr": sweeps * vcycles if periodic else 0,
            "poisson_apply_separable": 0, "zblocked_helmholtz_apply": 0,
            "convection3d_apply": 0}
    return [want[k] for k in sorted(want)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_decomposed_run_matches_jax(jobs, tmp_path, name):
    """A decomposed run of the port equals the JAX package's single-device
    run: fields (and forces) within JAX's sharded-versus-single bounds,
    every ``_iters``/``_ok`` stat equal on every step, the kernel
    wrappers called on every rank as the stats imply (K1-K3 never); the
    [2, 2, 2] sphere's iterations also equal the JAX package's own
    [2, 2, 2] run's."""
    job, shape, _, _, _, atol = CASES[name]
    jobs.jobs[job].check(f"{name}.npz")
    state, stats, _ = _run_jax(name, tmp_path / "single")
    got = jobs.case(name)
    for key, want in state["q"].items():
        np.testing.assert_allclose(got[f"q_{key}"], np.asarray(want),
                                   rtol=0, atol=atol, err_msg=key)
    np.testing.assert_allclose(got["p"], np.asarray(state["p"]), rtol=0,
                               atol=atol)
    if "f" in state:
        np.testing.assert_allclose(got["f"], np.asarray(state["f"]), rtol=0,
                                   atol=atol)
    keys = [k for k in stats[0] if k.endswith(("_iters", "_ok"))
            or k == "fallback"]
    assert keys
    for key in keys:
        np.testing.assert_array_equal(got[f"stat_{key}"],
                                      [s[key] for s in stats], err_msg=key)
    want_calls = _implied_calls(got)
    for rank, every in enumerate(got["ranks"]):
        assert every["calls"] == want_calls, (rank, name)
    if name == "sphere_2x2x2":
        _, sharded, _ = _run_jax(name, tmp_path / "sharded",
                                 dict(SHARDING, shape=[2, 2, 2]))
        for key in keys:
            np.testing.assert_array_equal(
                got[f"stat_{key}"], [s[key] for s in sharded], err_msg=key)


def _comm(got) -> dict:
    return {str(k): [int(c), int(b)] for k, (c, b)
            in zip(got["comm_keys"], got["comm"])}


def test_fdm_core_follows_mesh_and_repartition(jobs):
    """A 3-axis mesh or ``fdm.repartition: false`` takes the contraction
    core (no all-to-all on a grid without FFT axes: its transforms'
    partial sums move by ``reduce_scatter``), and a 2-axis mesh with
    repartition the four-all-to-all core (four all-to-alls a solve, no
    reduce_scatter): by the core's type and the collectives of each
    run."""
    for name in ("cavity_2x1x2", "cavity_norepart", "cylinder_norepart",
                 "sphere_2x2x2"):
        got = jobs.case(name)
        assert str(got["core"]) == "_ContractionCore", name
        comm = _comm(got)
        assert comm["alltoall"][0] == 0 and comm["reduce_scatter"][0] > 0, \
            (name, comm)
    for name in ("cylinder_windowed", "cavity_probes"):
        got = jobs.case(name)
        assert str(got["core"]) == "_ShardedTransformCore", name
        comm = _comm(got)
        assert comm["reduce_scatter"][0] == 0, (name, comm)
        assert comm["alltoall"][0] > 0 and comm["alltoall"][0] % 4 == 0, \
            (name, comm)


def test_no_whole_field_gather_for_probes_or_windowed(jobs):
    """On [2, 2] no rank gathers a whole field for the windowed engine (a
    step gathers nothing) or for a probe (each monitor call of the four
    probes sends the volume boxes' parts alone: two gathers, fewer bytes
    than the two boxes hold, and fewer than one pressure block)."""
    for name in ("cylinder_windowed", "oscillating_windowed"):
        got = jobs.case(name)
        for rank, every in enumerate(got["ranks"]):
            comm = dict(zip(sorted(got["comm_keys"]), every["comm"]))
            assert comm["gather"][0] == 0, (name, rank, comm)
    got = jobs.case("cavity_probes")
    seen = got["probe_gather"]
    assert len(seen) == CASES["cavity_probes"][4]
    calls, nbytes = (int(v) for v in seen.max(axis=0))
    assert calls == 2 and (seen[:, 0] == 2).all()
    # the boxes: p over 16 x 4 cells, v over 6 x 13 faces (16^2 cavity)
    assert nbytes < 8 * (16 * 4 + 6 * 13), nbytes
    assert nbytes < 8 * int(np.prod(got["block"])), nbytes


def test_decomposed_probe_files_match_jax(jobs, tmp_path):
    """The probes of the 4-step cavity on [2, 2], written by rank 0, equal
    the JAX package's single-device run's files: the same lines, numbers
    within 1e-12 of the file's largest."""
    from test_torch_probes import assert_probe_files_match

    jobs.jobs["four"].check("cavity_probes.npz")
    _, _, jax_out = _run_jax("cavity_probes", tmp_path / "single")
    got = jobs.case("cavity_probes")  # the run is done
    assert "p" in got
    rank0 = jobs.dir("four") / "cavity_probes-0" / "output"
    for probe in PROBES:
        assert_probe_files_match(rank0 / probe["path"],
                                 os.path.join(jax_out, probe["path"]))
    for rank in range(1, JOBS["four"]):
        other = jobs.dir("four") / f"cavity_probes-{rank}" / "output"
        assert not any((other / p["path"]).exists() for p in PROBES)


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
