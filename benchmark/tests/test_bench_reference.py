"""The plain references against the port on small cuts, in float64 on
the CPU, the port's solves converged far below rounding: the same step,
so the two agree to rounding.  The references import nothing of the
port.  Also what the harness refuses: an unknown solver or reference,
an initial field's expression it may not evaluate, a compared field with
no limit."""

from __future__ import annotations

import math
import os
import time

import numpy as np
import pytest

from benchmark import harness, inputs
from benchmark.reference.ibpm import DecoupledIBPM
from benchmark.reference.navierstokes import NavierStokes
from conftest import SMALL2D, SMALL3D, dump, load, periodic_bcs, tgv_case


def _solver_and_reference(root: str, config: str):
    from petibm_tpu_torch.convert import state_from_numpy
    from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver

    spec = harness.load_spec(root)
    cell = harness.Cell(root, spec, f"{config}.fdm_k4")
    cfg = cell.solver_config(os.path.join(root, "run"))
    cfg["parameters"]["dtype"] = "float64"
    cfg["parameters"]["stepsPerDispatch"] = 1
    for role in ("velocity", "poisson", "forces"):
        cfg["parameters"][f"{role}Solver"]["atol"] = 1e-13
    _, body = cell.body()
    ref = DecoupledIBPM(cfg, body, device="cpu")
    start = ref.initial_state(inputs.initial_velocity(ref, cell.case, 3))
    solver = DecoupledIBPMSolver(cfg, device="cpu")
    solver.state = state_from_numpy(start, solver.device, solver.dtype)
    return solver, ref, start


@pytest.mark.parametrize("config,steps", [(SMALL2D, 10), (SMALL3D, 5)])
def test_reference_equals_the_port(small_root, config, steps):
    from petibm_tpu_torch.convert import state_to_numpy

    solver, ref, start = _solver_and_reference(small_root, config)
    solver.nt = steps
    solver.run()
    got = state_to_numpy(solver.state)
    want = harness._reference_numpy(ref.advance(ref.load(start), steps))
    res = harness.gaps(got, want)
    assert set(res) == ({"u", "v", "p", "f"} | (
        {"w"} if config == SMALL3D else set()))
    assert max(res.values()) < 1e-10, res
    # the step moved the state: the gaps are not those of a still flow
    assert harness.gaps(start, want)["p"] > 0.5


def test_reference_follows_a_state_it_is_given(small_root):
    """Started from the port's state after some steps, the reference's
    next steps equal the port's: what the window's check relies on."""
    from petibm_tpu_torch.convert import state_to_numpy

    solver, ref, _ = _solver_and_reference(small_root, SMALL2D)
    solver.nt = 6
    solver.run()
    mid = state_to_numpy(solver.state)
    solver.nt = 10
    solver.run()
    got = state_to_numpy(solver.state)
    want = harness._reference_numpy(ref.advance(ref.load(mid), 4))
    assert max(harness.gaps(got, want).values()) < 1e-10


def test_tf32_rounding():
    import torch

    from benchmark.reference.ibpm import tf32

    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, -3.0 + 2 ** -20],
                     dtype=torch.float32)
    got = tf32(x).tolist()
    assert got[0] == 1.0 and got[2] == 1.0 + 2 ** -10
    assert got[1] in (1.0, 1.0 + 2 ** -10)  # a tie
    assert got[3] == -3.0
    r = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    err = ((tf32(r) - r).abs() / r.abs()).numpy()
    assert err.max() <= 2.0 ** -11 and err.max() > 2.0 ** -14


def _navierstokes_pair(case: dict, seed: int, workdir: str):
    """The port's NavierStokesSolver and the Navier-Stokes reference on
    ``case`` in float64, the solves converged far below rounding (the
    FDM velocity solve: both sides solve directly), from the seed's
    start."""
    from petibm_tpu_torch.convert import state_from_numpy
    from petibm_tpu_torch.solvers.navierstokes import NavierStokesSolver

    cfg = {k: case[k] for k in ("mesh", "flow", "parameters")}
    cfg["parameters"] = dict(cfg["parameters"], dtype="float64", nt=0,
                             nsave=10 ** 9, nrestart=10 ** 9)
    for role in ("velocity", "poisson"):
        cfg["parameters"][f"{role}Solver"] = dict(
            cfg["parameters"][f"{role}Solver"], atol=1e-13)
    cfg.update(directory=workdir, output=os.path.join(workdir, "output"),
               logs=os.path.join(workdir, "logs"))
    ref = NavierStokes(cfg, None, device="cpu")
    start = ref.initial_state(inputs.initial_fields(ref, case, seed))
    solver = NavierStokesSolver(cfg, device="cpu")
    harness._same_layout(harness._to_host(solver.state), start)
    solver.state = state_from_numpy(start, solver.device, solver.dtype)
    return solver, ref, start


def _channel(dim: int) -> dict:
    """A stretched box periodic in x, walled in y (and z) with a moving
    lid: the reference's Dirichlet walls beside a periodic axis."""
    case = tgv_case(dim, 12)
    case["flow"]["boundaryConditions"] = periodic_bcs(dim, walled=(1, 2))
    case["flow"]["nu"] = 0.02
    for ax in case["mesh"]:
        ax["subDomains"] = [
            {"end": 0.0, "cells": 7, "stretchRatio": 0.9},
            {"end": math.pi, "cells": 6, "stretchRatio": 1.1}]
    return case


@pytest.mark.parametrize("name,case,steps", [
    ("tgv2d_32", tgv_case(2, 32), 10), ("tgv3d_16", tgv_case(3, 16), 5),
    ("channel2d", _channel(2), 5), ("channel3d", _channel(3), 5)])
def test_navierstokes_reference_equals_the_port(tmp_path, name, case,
                                                steps):
    """Fields agree to 1e-9 of their largest value, the tolerance the
    port is held to against the JAX package."""
    from petibm_tpu_torch.convert import state_to_numpy

    solver, ref, start = _navierstokes_pair(case, 5, str(tmp_path))
    solver.nt = steps
    solver.run()
    got = state_to_numpy(solver.state)
    want = harness._reference_numpy(ref.advance(ref.load(start), steps))
    res = harness.gaps(got, want)
    assert set(res) == set("uvw"[:len(case["mesh"])]) | {"p"}
    assert max(res.values()) < 1e-9, res
    assert harness.gaps(start, want)["u"] > 1e-3


def test_initial_fields_are_the_ports():
    """The TGV's symbolic start evaluated by ``inputs`` equals the port's
    own (sympy) evaluation on the same points, to rounding."""
    from petibm_tpu_torch.ics import initial_fields
    from petibm_tpu_torch.mesh import StaggeredMesh

    case = tgv_case(3, 8)
    case["inputs"]["amplitude"] = 0.0
    ref = NavierStokes(case, None, device="cpu")
    got = inputs.initial_fields(ref, case, 1)
    want = initial_fields(case, StaggeredMesh(case))
    assert set(got) == set(want) == {"u", "v", "w", "p"}
    for k in want:
        assert got[k].shape == want[k].shape
        assert np.abs(got[k] - want[k]).max() < 1e-14, k
    assert np.abs(want["p"]).max() > 0.1


@pytest.mark.parametrize("text", [
    "x ^ 2", "foo * x", "__import__('os')", "x.real", "sin(x)[0]",
    "lambda: 1", "abs(x)", "sin(x, y=1)", "'a'", "x if y else z",
    "open('f')", "x +"])
def test_an_expression_it_may_not_evaluate_is_refused(text):
    with pytest.raises(inputs.ExpressionError):
        inputs.compile_expression(text)


def test_expressions_in_the_closed_namespace():
    axes = [np.array([0.0, 0.5]), np.array([1.0, 2.0, 3.0])]
    got = inputs.evaluate("sqrt(nu) * exp(x) * tan(y) + 2 ** 3 * pi - t",
                          axes, 0.25)
    x, y = axes[0][None, :], axes[1][:, None]
    np.testing.assert_array_equal(
        got, np.sqrt(0.25) * np.exp(x) * np.tan(y) + 8 * np.pi - 0.0)
    np.testing.assert_array_equal(inputs.evaluate("0", axes, 0.0),
                                  np.zeros((3, 2)))
    np.testing.assert_array_equal(inputs.evaluate(1.5, axes, 0.0),
                                  np.full((3, 2), 1.5))


def _edit_case(root: str, name: str, edit) -> None:
    path = os.path.join(root, "benchmark", "configs", name + ".json")
    case = load(path)
    edit(case)
    dump(path, case)


def _cpu_run(root: str, cell: str):
    return harness.run_cell(root, cell, 3, 0.1, False,
                            t_start=time.perf_counter(), device="cpu")


def test_an_unknown_solver_is_refused(small_root):
    _edit_case(small_root, "tgv2d", lambda c: c.update(solver="nonesuch"))
    with pytest.raises(harness.CellError) as exc:
        _cpu_run(small_root, "tgv2d.fdm_k4")
    for name in ("decoupledibpm", "ibpm", "rigidkinematics",
                 "navierstokes"):
        assert name in str(exc.value)


@pytest.mark.parametrize("name", ["nonesuch.NavierStokes",
                                  "navierstokes.Nonesuch", "navierstokes",
                                  "../ibpm.DecoupledIBPM",
                                  "navierstokes.np"])
def test_an_unknown_reference_is_refused(small_root, name):
    _edit_case(small_root, "tgv2d", lambda c: c.update(reference=name))
    with pytest.raises(harness.CellError):
        _cpu_run(small_root, "tgv2d.fdm_k4")


@pytest.mark.parametrize("key,text", [("initialVelocity", "x ^ 2"),
                                      ("initialVelocity", "cosh(x)"),
                                      ("initialPressure", "sin(q)")])
def test_a_refused_expression_stops_the_run(small_root, key, text):
    def edit(case):
        if key == "initialPressure":
            case["flow"][key] = text
        else:
            case["flow"][key][1] = text

    _edit_case(small_root, "tgv2d", edit)
    with pytest.raises(harness.CellError):
        _cpu_run(small_root, "tgv2d.fdm_k4")


@pytest.mark.parametrize("cell,field", [("tgv2d.fdm_k4", "p_gap"),
                                        ("small2d.fdm_k4", "f_gap")])
def test_a_compared_field_needs_a_limit(small_root, cell, field):
    path = os.path.join(small_root, "benchmark", "limits", cell + ".json")
    limits = load(path)
    del limits[field]
    dump(path, limits)
    with pytest.raises(harness.CellError, match=field):
        _cpu_run(small_root, cell)


@pytest.mark.parametrize("name", ["decoupledibpm", "ibpm", "rigidkinematics",
                                  "navierstokes"])
def test_each_solver_name_imports_its_class(small_root, name):
    _edit_case(small_root, "tgv2d", lambda c: c.update(solver=name))
    spec = harness.load_spec(small_root)
    cls = harness.Cell(small_root, spec, "tgv2d.fdm_k4").solver_class()
    module, cls_name = harness.SOLVERS[name]
    assert cls.__name__ == cls_name
    assert cls.__module__ == f"petibm_tpu_torch.solvers.{module}"


def test_bodies_are_passed_as_written(small_root):
    """A ``bodies`` list reaches the solver as written, each file beside
    the configuration; ``body`` with it, or a missing file, is refused;
    with neither key the solver gets no bodies."""
    spec = harness.load_spec(small_root)
    bodies = [{"type": "points", "file": "small2d.body",
               "kinematics": {"type": "oscillation", "amplitude": 0.1}}]
    _edit_case(small_root, "small2d",
               lambda c: (c.pop("body"), c.update(bodies=bodies)))
    cell = harness.Cell(small_root, spec, "small2d.fdm_k4")
    got = cell.solver_config(os.path.join(small_root, "run"))["bodies"]
    assert got == [dict(bodies[0], file=os.path.join(
        small_root, "benchmark", "configs", "small2d.body"))]
    assert cell.body() == (None, None)
    _edit_case(small_root, "small2d", lambda c: c.update(body="small2d.body"))
    with pytest.raises(harness.CellError, match="both"):
        harness.Cell(small_root, spec, "small2d.fdm_k4").solver_config("/r")
    _edit_case(small_root, "small2d", lambda c: (
        c.pop("body"), c.update(bodies=[dict(bodies[0], file="none.body")])))
    with pytest.raises(harness.CellError, match="none.body"):
        harness.Cell(small_root, spec, "small2d.fdm_k4").solver_config("/r")
    tgv = harness.Cell(small_root, spec, "tgv2d.fdm_k4")
    assert "bodies" not in tgv.solver_config("/r")
