"""The 256^3 Taylor-Green vortex at Re 1600 as the benchmark runs it
(``configs/tgv3d_re1600.json``, cell ``tgv3d_re1600.fdm_k5``): the
configuration is the example's, its seeded bumps leave the box's faces
untouched, a 16^3 cut runs correct on the CPU and a broken step does
not, and the cell's three new readers read what they should."""

from __future__ import annotations

import copy
import math
import os
import time

import numpy as np
import yaml

from benchmark import harness, inputs, spans
from conftest import ROOT, SMALL_LIMITS, dump, load, make_small_root

CONFIG = os.path.join(ROOT, "benchmark", "configs", "tgv3d_re1600.json")
EXAMPLE = os.path.join(ROOT, "examples", "navierstokes",
                       "taylorgreenvortex3dRe1600")
CELL = "tgv3d_re1600.fdm_k5"
CUT = "tgv16.fdm_k5_cut"
#: the largest a bump may leave on a face of the box
SEAM = 1e-7


def _case() -> dict:
    return load(CONFIG)


def test_the_configuration_is_the_example():
    """Mesh, flow, dt, schemes, ``fdm.velocity`` and each solve's method,
    tolerances and iteration cap as ``config.yaml`` and its
    ``config/*.info`` give them; nothing reduced; the repository's cell
    names the configuration and the new traffic."""
    from petibm_tpu_torch.config import solver_config

    case = _case()
    with open(os.path.join(EXAMPLE, "config.yaml")) as fh:
        example = yaml.safe_load(fh)
    assert case["reduced"] == [] and "body" not in case
    assert case["solver"] == "navierstokes"
    assert case["reference"] == "navierstokes.NavierStokes"
    assert case["mesh"] == example["mesh"]
    assert case["flow"] == example["flow"]
    params, want = case["parameters"], example["parameters"]
    for key in ("dt", "startStep", "convection", "diffusion"):
        assert params[key] == want[key], key
    assert params["fdm"]["velocity"] is want["fdm"]["velocity"] is False
    for role in ("velocity", "poisson"):
        ours = solver_config(case, role)
        theirs = solver_config(dict(example, directory=EXAMPLE), role)
        assert ours == theirs, role
    assert solver_config(case, "velocity")["type"] == "bicgstab"
    spec = harness.load_spec(ROOT)
    entry = next(w for w in spec["workloads"] if w["name"] == CELL)
    assert entry["config"] == "tgv3d_re1600" and entry["chips"] == 1
    traffic = load(os.path.join(ROOT, "benchmark", "traffic",
                                entry["traffic"] + ".json"))
    assert traffic["parameters"] == {"stepsPerDispatch": 5}


def _face_values(case: dict, n: int, monkeypatch) -> float:
    """The bumps' largest magnitude on the first and last points of each
    axis of an ``n``^3 grid of the box, every centre jittered as far out
    as the seed can put it (the jitter's draws all 0, then all 1)."""
    from benchmark.reference.navierstokes import NavierStokes

    cut = copy.deepcopy(case)
    for axis in cut["mesh"]:
        axis["subDomains"][0]["cells"] = n
    cfg = {k: cut[k] for k in ("mesh", "flow", "parameters")}
    grid = NavierStokes(cfg, None, device="cpu")
    flat = dict(cut, flow=dict(cut["flow"], initialVelocity=[0, 0, 0]))
    real = inputs._rng
    worst = 0.0
    for draw in (0.0, 1.0 - 1e-12):
        class Edge:
            """The seed's signs, every jitter draw ``draw``."""

            def __init__(self, seed, stream):
                self.choice = real(seed, stream).choice

            def random(self, shape, draw=draw):
                return np.full(shape, draw)

        monkeypatch.setattr(inputs, "_rng", Edge)
        fields = inputs.initial_velocity(grid, flat, 2 ** 31 + 5)
        for f in fields.values():
            for axis in range(3):
                for end in (0, -1):
                    face = np.take(f, end, axis=axis)
                    worst = max(worst, float(np.abs(face).max()))
    return worst


def test_the_bumps_leave_the_faces_untouched(monkeypatch):
    """Every bump, its centre as far out as the jitter puts it, is below
    ``SEAM`` on every face: in closed form, and on the points nearest the
    faces of a 64^3 grid of the box (the bumps alone)."""
    case = _case()
    spec = case["inputs"]
    region = np.asarray(spec["region"], np.float64)
    sites = np.asarray(spec["sites"])
    size = (region[:, 1] - region[:, 0]) / sites
    lo = region[:, 0] + 0.5 * size - 0.25 * size
    hi = region[:, 1] - 0.5 * size + 0.25 * size
    gap = min((lo + math.pi).min(), (math.pi - hi).min())
    amp, sigma = float(spec["amplitude"]), float(spec["sigma"])
    assert amp >= 0.01
    assert amp * math.exp(-0.5 * (gap / sigma) ** 2) < SEAM
    assert gap / sigma > 6.5
    assert _face_values(case, 64, monkeypatch) < SEAM
    # the CPU cut's start (height 0.05, sigma 0.6, 2^3 sites on [-2, 2])
    # does not
    loose = dict(case, inputs=dict(spec, amplitude=0.05, sigma=0.6,
                                   sites=[2, 2, 2],
                                   region=[[-2.0, 2.0]] * 3))
    assert _face_values(loose, 64, monkeypatch) > 1e-3


def _cut_root(tmp_path) -> str:
    """A benchmark root with the configuration cut to 16^3 and the
    traffic to one spin-up chunk and a window of three: new files and
    entries beside the CPU cuts of ``conftest``."""
    root = make_small_root(str(tmp_path))
    spec = load(os.path.join(root, "BENCHMARK.json"))
    base = os.path.join(root, spec["paths"][0])
    case = _case()
    for axis in case["mesh"]:
        axis["subDomains"][0]["cells"] = 16
    case["reduced"] = ["mesh"]
    dump(os.path.join(base, "configs", "tgv16.json"), case)
    traffic = load(os.path.join(ROOT, "benchmark", "traffic", "fdm_k5.json"))
    traffic.update(spinup_chunks=1, min_chunks=3, trace_chunks=1)
    dump(os.path.join(base, "traffic", "fdm_k5_cut.json"), traffic)
    dump(os.path.join(base, "limits", CUT + ".json"), SMALL_LIMITS)
    spec["configs"].append({"name": "tgv16", "source": "a CPU cut",
                            "file": "benchmark/configs/tgv16.json",
                            "reduced": ["mesh"], "why": "tests"})
    spec["workloads"].append({"name": CUT, "config": "tgv16",
                              "traffic": "fdm_k5_cut", "chips": 1,
                              "why": "tests"})
    for m in spec["per_layer"]:
        if CELL in m.get("workloads", ()) and CUT not in m["workloads"]:
            m["workloads"].append(CUT)
    dump(os.path.join(root, "BENCHMARK.json"), spec)
    return root


def _run(root, seed=2 ** 31 + 11, trace=False, **kw):
    return harness.run_cell(root, CUT, seed, 0.3, trace,
                            t_start=time.perf_counter(), device="cpu", **kw)


def _unchanged(step):
    def broken(state):
        _, stats = step(state)
        return state, stats
    return broken


def test_the_cut_runs_correct_and_a_broken_step_does_not(tmp_path):
    root = _cut_root(tmp_path)
    res = _run(root, control=True)
    assert res["correct"], res["checks"]
    assert list(res["checks"]) == ["u_gap", "v_gap", "w_gap", "p_gap"]
    limits = {k: c["limit"] for k, c in res["checks"].items()}
    lower = max(c["value"] / c["limit"] for c in res["checks"].values())
    upper = max(v / limits[k] for k, v in res["control"].items())
    assert upper > 10 * lower
    broken = _run(root, fault=_unchanged)
    assert broken["correct"] is False
    assert any(c["value"] > c["limit"] for c in broken["checks"].values())


def test_the_readers(tmp_path, monkeypatch):
    """On a traced CPU run ``velocity_iters`` reads the stats' velocity
    iterations and the two span readers find nothing (no card); with the
    span run forced onto the CPU's stamps they read the regions: an
    iteration's time times the iterations within solveVelocity's span,
    the convection within rhsVelocity's."""
    root = _cut_root(tmp_path)
    res = _run(root, trace=True)
    assert res["correct"]
    metrics = res["metrics"]
    assert metrics["velocity_iters"]["value"] >= 1
    assert "velocity_iteration_us" not in metrics
    assert "convection_ms" not in metrics

    spec = harness.load_spec(root)
    cell = harness.Cell(root, spec, CUT)
    import tempfile

    solver = cell.solver_class()(cell.solver_config(tempfile.mkdtemp(
        dir=str(tmp_path))), device="cpu")
    for _ in range(2):
        solver.nt += cell.k
        solver.run()
    run = harness.Run(cell, solver, solver.stats_history, 1.0, 0, None, [],
                      0)
    for name in ("velocity_iteration_us", "convection_ms"):
        assert harness._read_metric(cell, name, run) is None
    monkeypatch.setattr(spans, "MIN_CHUNKS", 3)
    monkeypatch.setattr(spans, "MIN_SECONDS", 0.0)
    monkeypatch.setattr(spans, "of", lambda r: spans.collect(r.solver,
                                                             r.cell.k))
    n0 = len(solver.stats_history)
    iteration_us = harness._read_metric(cell, "velocity_iteration_us", run)
    s = spans.SpanRun(solver.timers, cell.k)
    iters = np.array([h["v_iters"] for h in solver.stats_history[n0:]])
    assert iteration_us > 0 and iters.min() >= 1
    solve_us = s.phase_ms("solveVelocity") * 1e3
    assert iteration_us * np.median(iters) <= np.median(solve_us)
    conv_ms = harness._read_metric(cell, "convection_ms", run)
    assert 0 < conv_ms < np.median(s.phase_ms("rhsVelocity"))
    solver.close()
