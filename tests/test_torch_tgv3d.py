"""The 3D Taylor-Green vortex slice as a whole: the port against the JAX
package on taylorgreenvortex3dRe1600 cut to a 16^3 periodic box, with its
BiCGStab + Jacobi velocity solve (``fdm.velocity: false``) and symbolic
initial conditions, for 5 steps.

The JAX solver runs with its kernels on, as its tests run it on the CPU:
convection (K3), the BiCGStab operator (K2a) and the periodic Poisson
residual (K2b) are Pallas kernels in interpret mode (asserted).  The port
runs the same kernels' wrappers, i.e. their plain twins on CPU tensors.

(a) float64: u, v, w, p, dP to 1e-9 of their maximum, stats equal
(b) float32: u, v, w, p to 1e-4, ok flags equal; dP, the pressure
    increment (~1e-3 of p), is fixed only to the solve tolerance and is
    held to 1e-4 of p's maximum
(c) the kernels' wrappers are called as often as the stats imply (the
    counts ``chip_smoke.py`` holds the CUDA launches to), and the kinetic
    energy does not grow after the first step (whose AB2 start with a zero
    history over-weights the convection)
(d) the NS CLIs on one case directory write matching iterations logs
"""

import os

import jax
import numpy as np
import pytest
import torch

from petibm_tpu.solvers.navierstokes import NavierStokesSolver as JaxSolver
from petibm_tpu_torch.convert import state_to_numpy
from petibm_tpu_torch.solvers.navierstokes import (
    NavierStokesSolver as TorchSolver)
from test_torch_decoupledibpm import assert_fields_close
from test_torch_sphere3d import count_calls

torch.set_num_threads(2)

STAT_KEYS = ("v_iters", "v_ok", "p_iters", "p_ok")
NSTEPS = 5
PI = 3.141592653589793


def config(tmp_path, name, dtype="float64", n=16, **params):
    d = tmp_path / name
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
            "dt": 0.05, "nt": NSTEPS, "nsave": 100, "nrestart": 100,
            "dtype": dtype, "fdm": {"velocity": False},
            "convection": "ADAMS_BASHFORTH_2", "diffusion": "CRANK_NICOLSON",
            "velocitySolver": dict(solver, kspType="bicgstab"),
            "poissonSolver": dict(solver)}, **params),
    }


def fields(state):
    if isinstance(state["p"], torch.Tensor):
        state = state_to_numpy(state)
    return dict(state["q"], p=state["p"], dP=state["dP"])


def run_jax(cfg):
    solver = JaxSolver(cfg)
    # the JAX side really runs its Pallas kernels (interpret mode)
    assert solver.convect.__qualname__.startswith("make_pallas_convection")
    assert solver.A_momentum.__qualname__.startswith("make_pallas_momentum")
    assert solver._negA_p.__qualname__.startswith("make_zblocked_helmholtz")
    state, stats = solver.state, []
    for _ in range(NSTEPS):
        state, s = solver._step_fn(state)
        s = jax.device_get(s)
        stats.append({k: (int(s[k]) if k.endswith("_iters") else bool(s[k]))
                      for k in STAT_KEYS})
    solver.close()
    return jax.device_get(state), stats


def run_port(cfg):
    solver = TorchSolver(cfg, device="cpu")
    solver.run()
    solver.close()
    return solver, [{k: h[k] for k in STAT_KEYS}
                    for h in solver.stats_history]


@pytest.fixture(scope="module")
def jax_f64(tmp_path_factory):
    return run_jax(config(tmp_path_factory.mktemp("tgv"), "jax"))


def test_a_five_steps_float64(tmp_path, jax_f64):
    state, stats = jax_f64
    port, port_stats = run_port(config(tmp_path, "port"))
    assert port_stats == stats
    assert all(s["v_iters"] > 0 for s in stats)  # BiCGStab really iterates
    assert_fields_close(fields(port.state), fields(state), 1e-9)


def test_b_five_steps_float32(tmp_path):
    state, stats = run_jax(config(tmp_path, "jax", dtype="float32"))
    port, port_stats = run_port(config(tmp_path, "port", dtype="float32"))
    assert port.state["p"].dtype == torch.float32
    assert ([{k: s[k] for k in s if k.endswith("_ok")} for s in port_stats]
            == [{k: s[k] for k in s if k.endswith("_ok")} for s in stats])
    got, want = fields(port.state), fields(state)
    dp_err = np.abs(got.pop("dP") - want.pop("dP")).max()
    assert dp_err <= 1e-4 * np.abs(want["p"]).max()
    assert_fields_close(got, want, 1e-4)


def _energy(state):
    return 0.5 * sum(float(torch.sum(q * q)) for q in state["q"].values())


def test_c_kernel_calls_match_stats_and_energy_decays(tmp_path, monkeypatch):
    k2 = count_calls(monkeypatch, "zblocked_helmholtz_apply")
    k3 = count_calls(monkeypatch, "convection3d_apply")
    cfg = config(tmp_path, "port")
    port = TorchSolver(cfg, device="cpu")
    assert k2[0] == 0  # the Jacobi diagonal is probed on the closure
    energies = [_energy(port.state)]
    for _ in range(NSTEPS):
        port.advance()
        energies.append(_energy(port.state))
    port.close()
    hist = port.stats_history
    assert hasattr(port._negA_p, "scale")  # K2b
    # BiCGStab applies A once, then twice per iteration, per component;
    # the Poisson refinement applies K2b twice, then once per pass
    k2a = sum(3 * (1 + 2 * h["v_iters"]) for h in hist)
    k2b = sum(2 + h["p_iters"] for h in hist)
    assert k2[0] == k2a + k2b
    assert k3[0] == NSTEPS  # one launch forms the three components
    assert all(b <= a for a, b in zip(energies[1:], energies[2:])), energies


def _write_case(directory, cfg):
    import yaml

    os.makedirs(directory)
    node = {k: cfg[k] for k in ("mesh", "flow", "parameters")}
    with open(os.path.join(directory, "config.yaml"), "w") as fh:
        yaml.safe_dump(node, fh)


def test_d_cli_logs_match(tmp_path, capsys):
    from petibm_tpu.cli.navierstokes import main as jax_main
    from petibm_tpu_torch.cli.navierstokes import main as port_main

    cfg = config(tmp_path, "src", n=16, nt=6, nsave=3)
    _write_case(str(tmp_path / "jax_case"), cfg)
    _write_case(str(tmp_path / "port_case"), cfg)
    assert jax_main(["-directory", str(tmp_path / "jax_case")]) == 0
    assert port_main(["-directory", str(tmp_path / "port_case"),
                      "-device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[time step 6]" in out and "device: cpu" in out
    want = np.loadtxt(tmp_path / "jax_case" / "output" / "iterations-0.txt")
    got = np.loadtxt(tmp_path / "port_case" / "output" / "iterations-0.txt")
    assert got.shape == want.shape == (6, 5)
    np.testing.assert_array_equal(got[:, (0, 1, 3)], want[:, (0, 1, 3)])
    # residuals: printed to 6 digits, near the rounding floor
    np.testing.assert_allclose(got[:, 2::2], want[:, 2::2], rtol=1e-3,
                               atol=1e-12)
