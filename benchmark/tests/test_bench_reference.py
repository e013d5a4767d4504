"""The plain reference against the port on small cuts of the two
configurations, in float64 on the CPU, the port's solves converged far
below rounding: the same step, so the two agree to rounding.  The
reference itself imports nothing of the port."""

from __future__ import annotations

import os

import pytest

from benchmark import harness, inputs
from benchmark.reference.ibpm import DecoupledIBPM
from conftest import SMALL2D, SMALL3D


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
