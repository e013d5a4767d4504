"""The multigrid V-cycle, the coupled IBPM and the moving body on a
decomposed run of the port, on CPU processes over gloo, held to the JAX
package.

The ranks are processes of this file (``python test_torch_parallel_mg.py
<rank> <world> <port> <out>``, one torch thread each), started once by a
module fixture with a time limit, as in ``test_torch_parallel.py``.  Rank
0 writes what the ranks computed to ``<out>``; the tests run the JAX
package in this process on the same configurations.

(a) One decomposed V-cycle (``PoissonMG.set_mesh``) against the
    single-rank one to 1e-12 in float64, on [2, 2], [1, 4] and [4, 1]:
    a walled odd grid (27 x 21), a stretched 2D grid, a y-periodic grid
    and a 3D grid, each with ``consolidate_below`` 0 and at its default.
    Every rank's tensor at every level is its block while the level
    holds more cells than the threshold and its blocks and pencils hold
    lines (a coarse cell with the rank of its first child), and the
    whole level after.
(b) Whole runs on [2, 2] against the JAX package's single-device run:
    the MG-CG cases of ``test_torch_mgcg.py`` (``fdm: false`` cylinder,
    y-periodic cylinder, BN = 2 cavity, 16^3 TGV), each also with ``mg:
    {consolidateBelow: 16}``, fields to 1e-9 and every ``_iters``/``_ok``
    stat equal per step, the sweep wrappers called on every rank as the
    stats imply and K1-K3's never; the 32^2 cavity with ``mg: {dtype:
    bfloat16}``; the coupled cylinder, default and pinned, to JAX's own
    bounds (tests/test_parallel.py:196-217); the oscillating cylinder
    (tests/test_parallel.py:220-242, atol 1e-9, the ``fallback`` stat
    equal).  Where a decomposed run cannot share the single device's
    iteration counts (JAX drops the coupled direct solve under a mesh;
    the bfloat16 V-cycle rounds what the float64 reductions' order
    leaves), they are held to the JAX package's own 4-device sharded run
    on conftest's virtual CPU devices.
(c) The Krylov solvers' composite inner product: a replicated leaf counts
    once, and the decomposed {f, p} dot equals the single-rank one.
"""

from __future__ import annotations

import json
import math
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

from test_torch_parallel import (MESH_SHAPES, SHARDING, _grid,  # noqa: E402
                                 _start_job, _wait_job, cavity_config,
                                 cylinder_config, tgv_config)

#: the rank job's time limit (s)
TIMEOUT = 300
#: the default consolidation threshold (JAX navierstokes.py:523-524)
CONSOLIDATE = 4096

# --- (a) the V-cycle's grids -------------------------------------------------
VCYCLE_GRIDS = {
    "odd_walls": _grid([("x", 27, 1.0), ("y", 21, 1.0)]),
    "stretched": _grid([("x", 24, 1.06), ("y", 20, 0.95)]),
    "y_periodic": _grid([("x", 26, 1.04), ("y", 22, 1.0)], "y"),
    "walls_3d": _grid([("x", 13, 1.05), ("y", 12, 1.0), ("z", 9, 0.97)]),
}


# --- (b) the runs ----------------------------------------------------------
def _mgcg(cfg):
    cfg["parameters"]["fdm"] = False
    return cfg


def mgcg_cylinder(tmpdir, sharding=None, yperiodic=False):
    """test_torch_mgcg.py's cylinder: ``__graft_entry__``'s 32^2
    decoupled-IBPM cylinder in float64 with ``fdm: false``."""
    from __graft_entry__ import _cylinder_config

    os.makedirs(os.path.join(str(tmpdir), "output"), exist_ok=True)
    cfg = _cylinder_config(32, str(tmpdir))
    cfg["output"] = os.path.join(str(tmpdir), "output")
    cfg["logs"] = os.path.join(str(tmpdir), "logs")
    cfg["parameters"]["dtype"] = "float64"
    if yperiodic:
        for bc in cfg["flow"]["boundaryConditions"]:
            if bc["location"] in ("yMinus", "yPlus"):
                bc["u"] = ["PERIODIC", 0.0]
                bc["v"] = ["PERIODIC", 0.0]
    if sharding:
        cfg["parameters"]["sharding"] = sharding
    return _mgcg(cfg)


def mgcg_cavity_bn2(tmpdir, sharding=None):
    """test_torch_mgcg.py's cavity: a uniform 32^2 lid-driven cavity with
    BN = 2 (the V-cycle of the level-0 operator, no FDM)."""
    cfg = cavity_config(tmpdir, n=32, sharding=sharding)
    for axis in cfg["mesh"]:
        axis["subDomains"][0]["stretchRatio"] = 1.0
    cfg["parameters"] = {
        "dt": 0.01, "nt": 5, "nsave": 100, "nrestart": 100, "BN": 2,
        "dtype": "float64", "convection": "ADAMS_BASHFORTH_2",
        "diffusion": "CRANK_NICOLSON",
        "velocitySolver": {"type": "CPU"}, "poissonSolver": {"type": "CPU"}}
    if sharding:
        cfg["parameters"]["sharding"] = sharding
    return cfg


def mgcg_tgv(tmpdir, sharding=None):
    """The 16^3 TGV with ``fdm: false``: K6/K7 on every level."""
    return _mgcg(tgv_config(tmpdir, sharding=sharding))


def bf16_cavity(tmpdir, sharding=None):
    """The 32^2 cavity with the bfloat16 V-cycle under the float64 CG."""
    cfg = _mgcg(cavity_config(tmpdir, n=32, sharding=sharding))
    cfg["parameters"]["mg"] = {"dtype": "bfloat16"}
    return cfg


def coupled_pinned(tmpdir, sharding=None):
    cfg = cylinder_config(tmpdir, sharding=sharding)
    cfg["parameters"]["poissonSolver"]["type"] = "GPU"
    return cfg


def coupled_jacobi(tmpdir, sharding=None):
    """The coupled cylinder with the probed Jacobi pressure block: the
    outer CG on one device too."""
    cfg = cylinder_config(tmpdir, sharding=sharding)
    cfg["parameters"]["poissonSolver"]["pc"] = "jacobi"
    return cfg


def oscillating(tmpdir, sharding=None):
    cfg = cylinder_config(tmpdir, sharding=sharding)
    cfg["bodies"][0]["kinematics"] = {"type": "oscillation", "f": 0.2,
                                      "D": 0.4, "KC": 2.0}
    return cfg


def _with_consolidate(make, consolidate):
    def build(tmpdir, sharding=None):
        cfg = make(tmpdir, sharding=sharding)
        cfg["parameters"]["mg"] = {"consolidateBelow": consolidate}
        return cfg

    return build


NS = "navierstokes.NavierStokesSolver"
DECOUPLED = "decoupledibpm.DecoupledIBPMSolver"
_MG_CASES = {
    "cylinder": (mgcg_cylinder, DECOUPLED),
    "cylinder_yperiodic": (lambda t, sharding=None: mgcg_cylinder(
        t, sharding, yperiodic=True), DECOUPLED),
    "cavity_bn2": (mgcg_cavity_bn2, NS),
    "tgv": (mgcg_tgv, NS),
}
#: name -> (config, solver module.class, steps, bounds); bounds: "atol"
#: (every field, absolute) or "rel" (to the field's maximum), "iters":
#: "single" (equal to the JAX single-device run's) or "sharded" (to the
#: JAX package's 4-device run's), "f_rtol" for the coupled forces
CASES = {}
for _name, (_make, _cls) in _MG_CASES.items():
    CASES[_name] = (_make, _cls, 5, {"rel": 1e-9, "iters": "single"})
    CASES[f"{_name}_c16"] = (_with_consolidate(_make, 16), _cls, 5,
                             {"rel": 1e-9, "iters": "single"})
CASES.update({
    # the bfloat16 V-cycle: the JAX package's sharded run takes K1 off
    # its level-0 residual and sums in another order, and parts from its
    # single-device run by one iteration at step 4, as the port does;
    # fields to 1e-9 of their maxima (the float64 CG converges to 1e-12)
    "cavity_bf16": (bf16_cavity, NS, 5, {"rel": 1e-9, "iters": "sharded"}),
    # JAX's bounds (tests/test_parallel.py:196-217); no direct solve under
    # a mesh (JAX ibpm.py:97-101): the iterations are its sharded run's
    "coupled": (cylinder_config, "ibpm.IBPMSolver", 5,
                {"atol": 1e-6, "f_rtol": 1e-6, "iters": "sharded"}),
    # the pinned outer CG stalls near its tolerance (JAX ibpm.py:104-111)
    # and takes 270-340 iterations a step: the JAX package's own two
    # sharded runs (its LAPACK and its PCR line solves) part by up to 7
    # iterations in 5 steps; held to its sharded run within 10 after an
    # equal first step, every ok flag equal
    "coupled_pinned": (coupled_pinned, "ibpm.IBPMSolver", 3,
                       {"atol": 1e-6, "f_rtol": 1e-6, "iters": "sharded",
                        "iters_within": 10}),
    # the probed diagonal under a mesh (coloured by global index); 120-190
    # outer iterations a step, parted by one where the sums' order differs
    "coupled_jacobi": (coupled_jacobi, "ibpm.IBPMSolver", 3,
                       {"atol": 1e-6, "f_rtol": 1e-6, "iters": "single",
                        "iters_within": 2}),
    "oscillating": (oscillating, "rigidkinematics.RigidKinematicsSolver", 3,
                    {"atol": 1e-9, "iters": "single"}),
})


def _solver_class(name: str, package: str):
    import importlib

    module, cls = name.split(".")
    return getattr(importlib.import_module(f"{package}.solvers.{module}"),
                   cls)


# --- the rank processes ----------------------------------------------------
def _vcycle_checks(pmesh, seed) -> dict:
    """Each grid's decomposed V-cycle against the single-rank one: the
    relative error and the shape of this rank's tensor at each level
    (each sweep's phi), per consolidation threshold."""
    from petibm_tpu_torch.linalg.mg import PoissonMG
    from petibm_tpu_torch.mesh import StaggeredMesh
    from petibm_tpu_torch.parallel import Partition
    from petibm_tpu_torch.types import Field

    out = {}
    for gname, cfg in VCYCLE_GRIDS.items():
        mesh = StaggeredMesh(cfg)
        part = Partition(mesh, pmesh)
        b = torch.as_tensor(np.random.default_rng(seed).standard_normal(
            mesh.shape(Field.P)))
        for cb in (0, CONSOLIDATE):
            kw = dict(dtype=torch.float64, device="cpu", scale=0.01, pre=1,
                      post=1, consolidate_below=cb)
            single = PoissonMG(mesh.dxp, mesh.periodic, **kw)
            want = single.preconditioner()(b)
            dec = PoissonMG(mesh.dxp, mesh.periodic, **kw)
            dec.set_mesh(part)
            seen = {}
            smooth = dec.smooth

            def record(lvl, phi, rhs, sweeps, _smooth=smooth, _seen=seen):
                _seen.setdefault(lvl, set()).add(tuple(phi.shape))
                return _smooth(lvl, phi, rhs, sweeps)

            dec.smooth = record
            got = part.gather(dec.preconditioner()(
                part.scatter(b, Field.P)), Field.P)
            out[f"{gname}-{cb}"] = {
                "err": float((got - want).abs().max() / want.abs().max()),
                "bounds": part.bounds,
                "levels": [list(level.shape) for level in single.levels],
                "seen": {str(k): sorted(map(list, v))
                         for k, v in seen.items()},
                "ndec": len(dec.blocks)}
    return out


def _dot_check(pmesh) -> dict:
    """The composite {f, p} dot on the ranks against the single-rank one
    on the full arrays (float64)."""
    from petibm_tpu_torch.linalg.krylov import _dot
    from petibm_tpu_torch.mesh import StaggeredMesh
    from petibm_tpu_torch.parallel import GroupSum, Partition
    from petibm_tpu_torch.types import Field

    mesh = StaggeredMesh(VCYCLE_GRIDS["odd_walls"])
    part = Partition(mesh, pmesh)
    rng = np.random.default_rng(5)
    full = {k: torch.as_tensor(rng.standard_normal(shape)) for k, shape in
            (("p", mesh.shape(Field.P)), ("f", (24, 2)))}
    x = {"f": full["f"], "p": part.scatter(full["p"], Field.P)}
    want = _dot(full, full)
    got = _dot(x, x, GroupSum())
    return {"err": float(abs(got - want) / want)}


def _count_calls() -> dict:
    """Count every kernel wrapper the step reaches (the twins of K1-K7)."""
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


def _run_case(name, tmpdir, calls) -> dict:
    """The case decomposed on [2, 2]: its fields gathered, its stats per
    step and this rank's kernel-wrapper calls against the V-cycles."""
    from petibm_tpu_torch.convert import state_to_numpy

    build, cls, steps, _ = CASES[name]
    solver = _solver_class(cls, "petibm_tpu_torch")(
        build(tmpdir, sharding=dict(SHARDING, shape=[2, 2])), device="cpu")
    assert solver.part is not None
    for key in calls:
        calls[key] = 0
    state, stats = solver.state, []
    for _ in range(steps):
        state, s = solver._step_fn(state)
        stats.append({k: float(v) for k, v in s.items() if k != "f"})
    full = state_to_numpy(state, solver.part)
    solver.close()
    out = {f"q_{k}": v for k, v in full["q"].items()}
    out["p"] = full["p"]
    if "f" in full:
        out["f"] = full["f"]
    for key in stats[0]:
        out[f"stat_{key}"] = np.array([s[key] for s in stats])
    mg = getattr(solver, "poisson_mg_lp", None) or getattr(
        solver, "poisson_mg", None)
    out["calls"] = np.array([calls[k] for k in sorted(calls)])
    out["sweeps"] = np.array(
        [mg.sweeps_per_vcycle() if mg is not None else -1,
         int(mg is not None and any(mg.levels[0].periodic)),
         len(mg.blocks) if mg is not None else 0])
    return out


def _job(rank, out):
    import torch.distributed as dist

    from petibm_tpu_torch.parallel import ProcessMesh

    res = {"vcycle": {}, "dot": {}}
    for shape in MESH_SHAPES:
        pm = ProcessMesh(shape)
        tag = f"{shape[0]}x{shape[1]}"
        res["vcycle"][tag] = _vcycle_checks(pm, seed=3)
        res["dot"][tag] = _dot_check(pm)
    calls = _count_calls()
    arrays = {}
    for name in CASES:
        arrays[name] = _run_case(name, os.path.join(out, f"{name}-{rank}"),
                                 calls)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, {"vcycle": res["vcycle"], "calls": {
        name: arr["calls"].tolist() for name, arr in arrays.items()}})
    if rank == 0:
        res["ranks"] = every
        with open(os.path.join(out, "mg.json"), "w") as fh:
            json.dump(res, fh)
        for name, arr in arrays.items():
            np.savez(os.path.join(out, f"{name}.npz"), **arr)


def _rank_main(argv) -> None:
    import torch.distributed as dist

    rank, world, port, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    _job(rank, out)
    dist.destroy_process_group()


# --- the tests' side ---------------------------------------------------------
class _Ranks:
    """The rank job, started when the module's first test asks for it;
    ``result()`` waits for it (at most ``TIMEOUT`` s from the start) and
    reads what rank 0 wrote.  The run tests take their JAX references
    before they wait, so those runs overlap the ranks'."""

    def __init__(self, out):
        import time

        self.out = out
        self.deadline = time.monotonic() + TIMEOUT
        self.procs = _start_job([os.path.abspath(__file__)], 4, out)
        self.res = None

    def result(self) -> dict:
        import time

        if self.res is None:
            _wait_job(self.procs, max(self.deadline - time.monotonic(), 1.0))
            with open(self.out / "mg.json") as fh:
                res = json.load(fh)
            res["cases"] = {name: dict(np.load(self.out / f"{name}.npz"))
                            for name in CASES}
            self.res = res
        return self.res


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    job = _Ranks(tmp_path_factory.mktemp("mg_ranks"))
    yield job
    for p in job.procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _run_jax(name, tmpdir, sharded: bool):
    """The JAX package's run of a case: its state and stats per step; on
    4 of conftest's 8 virtual devices ([2, 2]) when ``sharded``.  The
    bfloat16 V-cycle runs as on its chip (its Pallas kernels in interpret
    mode), the path whose arithmetic the port's kernels follow."""
    import jax

    build, cls, steps, _ = CASES[name]
    sharding = dict(SHARDING, nDevices=4, shape=[2, 2]) if sharded else None
    solver = _solver_class(cls, "petibm_tpu")(build(tmpdir,
                                                    sharding=sharding))
    lp = getattr(solver, "poisson_mg_lp", None)
    if lp is not None:
        lp.use_pcr = lp._pallas_interpret = True
    state, stats = solver.state, []
    for _ in range(steps):
        state, s = solver._step_fn(state)
        s = jax.device_get(s)
        stats.append({k: float(v) for k, v in s.items() if k != "f"})
    state = jax.device_get(state)
    solver.close()
    return state, stats


def _implied_calls(got) -> list:
    """The kernel wrappers' calls the stats imply on each rank (sorted by
    name): sweeps_per_vcycle() x V-cycles (one a CG iteration and one for
    the first residual), K4/K5 on walled levels, K6/K7 on periodic ones,
    none where no V-cycle runs; K1-K3 off under a mesh."""
    sweeps, periodic, _ = (int(v) for v in got["sweeps"])
    vcycles = int(np.sum(got["stat_p_iters"] + 1)) if sweeps > 0 else 0
    want = {"fused_sweep": 0 if periodic else sweeps * vcycles,
            "pcr": sweeps * vcycles if periodic else 0,
            "poisson_apply_separable": 0, "zblocked_helmholtz_apply": 0,
            "convection3d_apply": 0}
    return [want[k] for k in sorted(want)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_decomposed_run_matches_jax(ranks, tmp_path, name):
    """(b) A 4-rank [2, 2] run of the port against the JAX package's
    single-device run: fields (and forces) within the case's bounds,
    every _iters/_ok (and ``fallback``) stat equal per step to the JAX
    single-device run's or, where the case says so, to its sharded run's;
    on every rank the sweep wrappers were called as the stats imply and
    K1-K3's never."""
    _, _, steps, bounds = CASES[name]
    state, stats = _run_jax(name, tmp_path / "single", sharded=False)
    if bounds["iters"] == "sharded":
        _, stats = _run_jax(name, tmp_path / "sharded", sharded=True)
    res = ranks.result()
    got = res["cases"][name]
    fields = {f"q_{k}": v for k, v in state["q"].items()}
    fields["p"] = state["p"]
    for key, want in fields.items():
        want = np.asarray(want)
        atol = bounds.get("atol", bounds.get("rel", 0.0)
                          * np.abs(want).max())
        np.testing.assert_allclose(got[key], want, rtol=0, atol=atol,
                                   err_msg=key)
    if "f" in state:
        want = np.asarray(state["f"])
        np.testing.assert_allclose(
            got["f"], want, rtol=bounds.get("f_rtol", 0.0),
            atol=bounds.get("atol", bounds.get("rel", 0.0)
                            * np.abs(want).max()))
    keys = [k for k in stats[0] if k.endswith(("_iters", "_ok"))
            or k == "fallback"]
    assert keys and all(f"stat_{k}" in got for k in keys)
    within = bounds.get("iters_within", 0)
    for key in keys:
        want = np.array([s[key] for s in stats])
        if key.endswith("_iters") and within:
            assert got[f"stat_{key}"][0] == want[0], key
            assert np.abs(got[f"stat_{key}"] - want).max() <= within, (
                key, got[f"stat_{key}"], want)
        else:
            np.testing.assert_array_equal(got[f"stat_{key}"], want,
                                          err_msg=key)
    want_calls = _implied_calls(got)
    for rank, every in enumerate(res["ranks"]):
        assert every["calls"][name] == want_calls, (rank, name)
    if name.endswith("_c16"):
        # the fine levels really decompose
        assert int(got["sweeps"][2]) >= 2, name


def _expected_blocks(bounds, levels, cb, parts):
    """Per level: the blocks of every rank (bounds per direction), or None
    where the level runs whole: a coarse cell goes with its first child,
    and a level stays decomposed while it holds more than ``cb`` cells,
    each cut block at least 2 cells and each pencil at least a line."""
    dim = len(bounds)
    out = []
    for lvl, shape in enumerate(levels):
        if lvl:
            bounds = [[(b + 1) // 2 for b in bnd] for bnd in bounds]
        sizes = [[b - a for a, b in zip(bnd, bnd[1:])] for bnd in bounds]
        holds = all(parts[d] == 1 or (
            min(sizes[d]) >= 2 and min(sizes[1 if d == 0 else 0]) >= parts[d])
            for d in range(dim))
        if math.prod(shape) <= cb or not holds:
            out.extend([None] * (len(levels) - lvl))
            break
        out.append(bounds)
    return out


@pytest.mark.parametrize("grid", sorted(VCYCLE_GRIDS))
@pytest.mark.parametrize("shape", [f"{a}x{b}" for a, b in MESH_SHAPES])
def test_decomposed_vcycle_matches_single(ranks, shape, grid):
    """(a) One V-cycle (the preconditioner, its means over the group) on
    the ranks equals the single-rank one to 1e-12 in float64; every rank
    holds its block of each level above the threshold whose blocks and
    pencils hold lines, and the whole level below; with no threshold at
    least two 2D levels stay decomposed."""
    res = ranks.result()
    dy, dx = (int(v) for v in shape.split("x"))
    for cb in (0, CONSOLIDATE):
        key = f"{grid}-{cb}"
        ref = res["vcycle"][shape][key]
        assert ref["err"] <= 1e-12, (key, ref["err"])
        levels = ref["levels"]
        dim = len(levels[0])
        parts = [dx, dy, 1][:dim]
        blocks = _expected_blocks(ref["bounds"], levels, cb, parts)
        assert ref["ndec"] == sum(b is not None for b in blocks)
        if cb == 0 and dim == 2 and shape == "2x2":
            assert ref["ndec"] >= 2
        for rank, every in enumerate(res["ranks"]):
            seen = every["vcycle"][shape][key]["seen"]
            iy, ix = divmod(rank, dx)
            coord = [ix, iy, 0][:dim]
            for lvl, full in enumerate(levels):
                got = seen[str(lvl)]
                if blocks[lvl] is None:
                    assert got == [full], (key, rank, lvl)
                    continue
                want = [blocks[lvl][d][coord[d] + 1] - blocks[lvl][d][coord[d]]
                        for d in reversed(range(dim))]
                assert got == [want], (key, rank, lvl, got, want)
                assert want != full


def test_composite_dot_counts_replicated_leaves_once():
    """(c) ``_dot`` with a group sum: the replicated forces' product
    enters once, the decomposed pressure's partials are summed (here a
    stand-in group of 4 equal ranks)."""
    from petibm_tpu_torch.linalg.krylov import _dot

    class FourRanks:
        replicated = frozenset({"f"})

        def __call__(self, t):
            return 4 * t

    rng = np.random.default_rng(2)
    x = {"p": torch.as_tensor(rng.standard_normal((5, 6))),
         "f": torch.as_tensor(rng.standard_normal((7, 2)))}
    want = torch.sum(x["f"] * x["f"]) + 4 * torch.sum(x["p"] * x["p"])
    assert torch.equal(_dot(x, x, FourRanks()), want)
    # without replicated leaves the whole partial is summed
    assert torch.equal(_dot(x["p"], x["p"], FourRanks()),
                       4 * torch.sum(x["p"] * x["p"]))


@pytest.mark.parametrize("shape", [f"{a}x{b}" for a, b in MESH_SHAPES])
def test_decomposed_composite_dot_matches_single(ranks, shape):
    """(c) The {f, p} dot on the ranks (the forces replicated, the pressure
    decomposed) equals the single-rank dot to 1e-14."""
    assert ranks.result()["dot"][shape]["err"] <= 1e-14


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
