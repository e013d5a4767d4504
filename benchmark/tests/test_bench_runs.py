"""Whole runs on the CPU cuts: the last line's keys, the control that
must fail, a run with the timed path broken underneath, the existing
configurations' set-up as it was, and cells, traffic mixes and per-layer
metrics added by new files and entries alone."""

from __future__ import annotations

import io
import json
import os
import time

import pytest
import torch

from benchmark import harness
from conftest import SMALL_CELLS, dump, load, tgv_case

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _run(root, cell, seed=11, trace=False, **kw):
    return harness.run_cell(root, cell, seed, 0.3, trace,
                            t_start=time.perf_counter(), device="cpu", **kw)


def _last_line(result: dict) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    harness.print_result(dict(result), out, err)
    return (json.loads(out.getvalue().strip().splitlines()[-1]),
            err.getvalue().strip().splitlines())


@pytest.mark.parametrize("cell", sorted(SMALL_CELLS))
def test_last_line_has_the_contract_keys(small_root, cell):
    line, err = _last_line(_run(small_root, cell))
    assert list(line) == KEYS
    assert line["correct"] is True
    assert set(line["metrics"]) == {"step_ms", "chunk_ms_p95", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and set(m) == {"value", "unit"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["attempted"] >= 1 and line["failed"] == 0
    # the compared numbers, each beside its limit, last on stderr too
    checks = line["checks"]
    assert err[-len(checks):] == [
        f"check {k} {c['value']!r} limit {c['limit']!r}"
        for k, c in checks.items()]


def test_traced_line(small_root):
    line, _ = _last_line(_run(small_root, "small2d.mgcg_k2", trace=True))
    assert list(line) == KEYS[:5] + ["breakdown", "checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    # on the CPU only the program's counters have something to read
    assert set(line["metrics"]) == {"pressure_iters", "window_overflows"}
    assert line["metrics"]["pressure_iters"]["value"] > 1
    assert line["metrics"]["window_overflows"]["value"] == 0


@pytest.mark.parametrize("cell", ["cylinder2d_re200.fdm_k100",
                                  "sphere3d_re300.fdm_k10"])
def test_same_seed_same_inputs(cell):
    """A seed makes its inputs; every seed's bumps are as strong."""
    from benchmark import inputs
    from benchmark.reference.ibpm import DecoupledIBPM
    from conftest import ROOT

    spec = harness.load_spec(ROOT)
    c = harness.Cell(ROOT, spec, cell)
    grid = DecoupledIBPM(c.solver_config(ROOT), c.body()[1], device="cpu")
    base = c.case["flow"]["initialVelocity"]
    seeds = [2 ** 31 + s for s in range(6)]
    fields = [inputs.initial_velocity(grid, c.case, s) for s in seeds]
    again = inputs.initial_velocity(grid, c.case, seeds[0])
    assert all((fields[0][k] == again[k]).all() for k in again)
    assert any((fields[0][k] != fields[1][k]).any() for k in again)
    for f in fields:
        reach = max(abs(v - base[i]).max() for i, v in enumerate(f.values()))
        assert 0.045 < reach < 0.065
    assert len({inputs.sample_chunk(s, 200) for s in seeds}) > 1
    assert all(0 <= inputs.sample_chunk(s, 200) < 200 for s in seeds)


@pytest.mark.parametrize("cell", sorted(SMALL_CELLS))
def test_the_control_fails(small_root, cell):
    """The reference in TF32 in the program's place fails the cell's
    limits; the program passes them (its readings far below)."""
    res = _run(small_root, cell, control=True)
    assert res["correct"]
    limits = {k: c["limit"] for k, c in res["checks"].items()}
    assert any(v > limits[k] for k, v in res["control"].items()), res
    lower = max(c["value"] / c["limit"] for c in res["checks"].values())
    upper = max(v / limits[k] for k, v in res["control"].items())
    assert upper > 10 * lower


def _unchanged(step):
    def broken(state):
        _, stats = step(state)
        return state, stats
    return broken


def _altered(step):
    def broken(state):
        new, stats = step(state)
        u = new["q"]["u"].clone()
        mid = tuple(n // 2 for n in u.shape)
        u[mid] = u[mid] + 0.01 * u.abs().max()
        return dict(new, q=dict(new["q"], u=u)), stats
    return broken


@pytest.mark.parametrize("fault", [_unchanged, _altered],
                         ids=["state_unchanged", "answer_altered"])
@pytest.mark.parametrize("cell", ["small2d.fdm_k4", "small3d.fdm_k4",
                                  "tgv2d.fdm_k4"])
def test_a_broken_step_is_not_correct(small_root, cell, fault):
    """The rest of a run with the timed path broken underneath: the
    check reads it as not correct.  (A half batch and the exchange
    between chips are faults these one-chip cells cannot have.)"""
    res = _run(small_root, cell, fault=fault)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_cells_and_metrics_are_added_by_files(small_root):
    """A throwaway configuration, traffic mix, cell and per-layer metric:
    new files and new entries, no file edited."""
    root = small_root
    spec = load(os.path.join(root, "BENCHMARK.json"))
    base = os.path.join(root, spec["paths"][0])
    case = load(os.path.join(base, "configs", "small2d.json"))
    case["parameters"]["dt"] = 0.004
    dump(os.path.join(base, "configs", "throwaway.json"), case)
    traffic = load(os.path.join(base, "traffic", "fdm_k4.json"))
    traffic["parameters"]["stepsPerDispatch"] = 3
    dump(os.path.join(base, "traffic", "throwaway_k3.json"), traffic)
    dump(os.path.join(base, "limits", "throwaway.throwaway_k3.json"),
         load(os.path.join(base, "limits", "small2d.fdm_k4.json")))
    with open(os.path.join(base, "metrics", "throwaway_steps.py"), "w") as fh:
        fh.write("def read(run):\n    return len(run.stats)\n")
    spec["configs"].append({"name": "throwaway", "source": "a test",
                            "file": "benchmark/configs/throwaway.json",
                            "reduced": case["reduced"], "why": "a test"})
    spec["workloads"].append({"name": "throwaway.throwaway_k3",
                              "config": "throwaway",
                              "traffic": "throwaway_k3", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "throwaway_steps", "unit": "steps",
                              "better": "higher",
                              "source": "program_counter", "layer": "Entry",
                              "moves": "step_ms",
                              "workloads": ["throwaway.throwaway_k3"]})
    dump(os.path.join(root, "BENCHMARK.json"), spec)
    res = _run(root, "throwaway.throwaway_k3", trace=True)
    assert res["correct"]
    steps = res["metrics"]["throwaway_steps"]["value"]
    assert steps == 3 * res["attempted"]
    assert "pressure_iters" not in res["metrics"]
    assert "window_overflows" not in res["metrics"]


@pytest.mark.parametrize("cell", ["cylinder2d_re200.fdm_k100",
                                  "sphere3d_re300.fdm_k10"])
@pytest.mark.parametrize("seed", [0, 7])
def test_the_cells_start_as_before(cell, seed):
    """The two configurations name no reference and one body: the
    decoupled solver, ``ibpm.DecoupledIBPM``, the solver configuration
    the harness always built, and the start ``DecoupledIBPM`` built
    directly makes, bit for bit."""
    import numpy as np

    from benchmark import inputs
    from benchmark.reference.ibpm import DecoupledIBPM
    from conftest import ROOT
    from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver

    c = harness.Cell(ROOT, harness.load_spec(ROOT), cell)
    assert c.solver_class() is DecoupledIBPMSolver
    assert c.reference_class() is DecoupledIBPM
    cfg = c.solver_config("/run")
    path, body = c.body()
    want = {k: c.case[k] for k in ("mesh", "flow")}
    want["parameters"] = dict(c.case["parameters"],
                              **c.traffic["parameters"], nt=0,
                              nsave=10 ** 9, nrestart=10 ** 9)
    want["bodies"] = [{"type": "points", "file": path}]
    assert {k: v for k, v in cfg.items()
            if k not in ("directory", "output", "logs")} == want
    grid = DecoupledIBPM(cfg, body, device="cpu")
    direct = grid.initial_state(inputs.initial_velocity(grid, c.case, seed))
    got = harness.start_state(c, cfg, body, seed)

    def same(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, tuple):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b)

    same(got, direct)


def _add_tgv3d(root: str) -> str:
    """A bodyless, fully periodic Navier-Stokes configuration at 16^3
    with symbolic initial velocity and pressure, BiCGStab + Jacobi
    velocity and FDM pressure, 3 steps a chunk: new files and entries."""
    spec = load(os.path.join(root, "BENCHMARK.json"))
    base = os.path.join(root, spec["paths"][0])
    case = tgv_case(3, 16)
    assert "body" not in case and "bodies" not in case
    dump(os.path.join(base, "configs", "tgv3d.json"), case)
    dump(os.path.join(base, "traffic", "bicgstab_k3.json"), {
        "why": "BiCGStab + Jacobi velocity, FDM pressure, 3 steps a chunk",
        "parameters": {"stepsPerDispatch": 3,
                       "velocitySolver": {"kspType": "bicgstab",
                                          "pc": "jacobi"}},
        "spinup_chunks": 1, "min_chunks": 3, "trace_chunks": 1})
    dump(os.path.join(base, "limits", "tgv3d.bicgstab_k3.json"),
         {"u_gap": 1e-4, "v_gap": 1e-4, "w_gap": 1e-4, "p_gap": 1e-4})
    spec["configs"].append({"name": "tgv3d", "source": "a test",
                            "file": "benchmark/configs/tgv3d.json",
                            "reduced": case["reduced"], "why": "a test"})
    spec["workloads"].append({"name": "tgv3d.bicgstab_k3",
                              "config": "tgv3d", "traffic": "bicgstab_k3",
                              "chips": 1, "why": "a test"})
    dump(os.path.join(root, "BENCHMARK.json"), spec)
    return "tgv3d.bicgstab_k3"


def test_a_navierstokes_cell_is_added_by_files(small_root):
    """The port's NavierStokesSolver against ``navierstokes.NavierStokes``,
    added without editing a file: correct, the control fails its limits,
    and a broken step reads not correct."""
    cell = _add_tgv3d(small_root)
    res = _run(small_root, cell, control=True)
    assert res["correct"], res["checks"]
    assert list(res["checks"]) == ["u_gap", "v_gap", "w_gap", "p_gap"]
    limits = {k: c["limit"] for k, c in res["checks"].items()}
    assert any(v > limits[k] for k, v in res["control"].items())
    lower = max(c["value"] / c["limit"] for c in res["checks"].values())
    upper = max(v / limits[k] for k, v in res["control"].items())
    assert upper > 10 * lower
    for fault in (_unchanged, _altered):
        assert _run(small_root, cell, fault=fault)["correct"] is False


@pytest.mark.cuda
def test_cells_on_the_card(cuda):
    """Each cell for a short window on the card: a correct result line
    whose device is the card (run on the card: ``python -m pytest
    benchmark/tests -m cuda``)."""
    import subprocess
    import sys

    from conftest import ROOT

    spec = load(os.path.join(ROOT, "BENCHMARK.json"))
    for w in spec["workloads"]:
        proc = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", w["name"],
             "--seed", "2147483659", "--seconds", "2", "--trace", "1"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        assert line["correct"] and line["device"]["platform"] == "gpu"
        assert line["device"]["kind"] == torch.cuda.get_device_name()
        for name, m in line["metrics"].items():
            if name.endswith("_roofline"):
                assert 0 < m["value"] <= 105
