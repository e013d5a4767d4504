"""The 3D decoupled-IBPM sphere slice as a whole: the port against the JAX
package on the sphere3dRe300 case cut to a 24x20x16 stretched, walled grid
with a 100-point sphere generated here, for 5 steps.

The JAX solver runs with its kernels on, as its tests run it on the CPU:
convection (K3), the momentum operator of the FDM refinement (K2a) and
the Poisson residual (K1) are Pallas kernels in interpret mode (asserted).
The port runs the same kernels' wrappers, i.e. their plain twins on CPU
tensors.

(a) float64: u, v, w, p, dP, f, df to 1e-9 of their maximum, stats equal
(b) float32: the same fields to 1e-4, ok flags equal
(c) the kernels' wrappers are called as often as the stats imply (the
    counts ``chip_smoke.py`` holds the CUDA launches to)
(d) with ``disablePallas`` (the stencil closures) the port equals the
    same JAX run to 1e-9, stats equal
"""

import os

import jax
import numpy as np
import pytest
import torch

from petibm_tpu.solvers.decoupledibpm import DecoupledIBPMSolver as JaxSolver
from petibm_tpu_torch.convert import state_to_numpy
from petibm_tpu_torch.operators import cuda_stencil as cs
from petibm_tpu_torch.solvers.decoupledibpm import (
    DecoupledIBPMSolver as TorchSolver)
from test_torch_decoupledibpm import assert_fields_close

torch.set_num_threads(2)

STAT_KEYS = ("v_iters", "v_ok", "p_iters", "p_ok", "f_iters", "f_ok")
NSTEPS = 5


def sphere_body(path, n):
    """n points on the unit-diameter sphere (Fibonacci lattice)."""
    k = np.arange(n) + 0.5
    polar = np.arccos(1.0 - 2.0 * k / n)
    azim = np.pi * (1.0 + 5.0 ** 0.5) * k
    xyz = 0.5 * np.stack([np.cos(azim) * np.sin(polar),
                          np.sin(azim) * np.sin(polar), np.cos(polar)], 1)
    with open(path, "w") as fh:
        fh.write(f"{n}\n")
        for row in xyz:
            fh.write("\t".join(f"{v:.10e}" for v in row) + "\n")
    return path


def _axis(d, n_lo, n, end):
    """-2 .. -0.6 stretched, a uniform 8-cell patch to 0.6, stretched on."""
    return {"direction": d, "start": -2.0, "subDomains": [
        {"end": -0.6, "cells": n_lo, "stretchRatio": 0.9},
        {"end": 0.6, "cells": 8, "stretchRatio": 1.0},
        {"end": end, "cells": n - n_lo - 8, "stretchRatio": 1.1}]}


def config(tmp_path, name, dtype="float64", **params):
    d = tmp_path / name
    d.mkdir(parents=True)
    faces = {"xMinus": "DIRICHLET", "xPlus": "CONVECTIVE",
             "yMinus": "DIRICHLET", "yPlus": "DIRICHLET",
             "zMinus": "DIRICHLET", "zPlus": "DIRICHLET"}
    solver = {"type": "CPU", "atol": 1e-6, "rtol": 0.0}
    return {
        "directory": str(d), "output": str(d), "logs": str(d),
        "mesh": [_axis("x", 7, 24, 3.0), _axis("y", 6, 20, 2.0),
                 _axis("z", 4, 16, 2.0)],
        "flow": {"nu": 0.01, "initialVelocity": [1.0, 0.0, 0.0],
                 "boundaryConditions": [
                     {"location": loc, "u": [t, 1.0],
                      "v": [t, 1.0 if t == "CONVECTIVE" else 0.0],
                      "w": [t, 1.0 if t == "CONVECTIVE" else 0.0]}
                     for loc, t in faces.items()]},
        "parameters": dict({
            "dt": 0.01, "nt": NSTEPS, "nsave": 100, "nrestart": 100,
            "dtype": dtype, "convection": "ADAMS_BASHFORTH_2",
            "diffusion": "CRANK_NICOLSON", "velocitySolver": dict(solver),
            "poissonSolver": dict(solver), "forcesSolver": dict(solver)},
            **params),
        "bodies": [{"type": "points",
                    "file": sphere_body(os.path.join(d, "sphere.body"), 100)}],
    }


def fields(state):
    if isinstance(state["p"], torch.Tensor):
        state = state_to_numpy(state)
    return dict(state["q"], p=state["p"], dP=state["dP"], f=state["f"],
                df=state["df"])


def run_jax(cfg):
    solver = JaxSolver(cfg)
    # the JAX side really runs its Pallas kernels (interpret mode)
    assert solver.convect.__qualname__.startswith("make_pallas_convection")
    assert solver.A_momentum.__qualname__.startswith("make_pallas_momentum")
    assert solver._negA_p.__qualname__.startswith("make_pallas_poisson")
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
    return run_jax(config(tmp_path_factory.mktemp("sphere"), "jax"))


def test_a_five_steps_float64(tmp_path, jax_f64):
    state, stats = jax_f64
    port, port_stats = run_port(config(tmp_path, "port"))
    assert port_stats == stats
    assert_fields_close(fields(port.state), fields(state), 1e-9)


def test_b_five_steps_float32(tmp_path):
    state, stats = run_jax(config(tmp_path, "jax", dtype="float32"))
    port, port_stats = run_port(config(tmp_path, "port", dtype="float32"))
    assert port.state["p"].dtype == torch.float32
    assert ([{k: s[k] for k in s if k.endswith("_ok")} for s in port_stats]
            == [{k: s[k] for k in s if k.endswith("_ok")} for s in stats])
    assert_fields_close(fields(port.state), fields(state), 1e-4)


def count_calls(monkeypatch, name):
    """Count the calls of the kernel wrapper ``cs.<name>`` (on the CPU
    the twins run and the launch counters stay still)."""
    calls = [0]
    real = getattr(cs, name)

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(cs, name, counted)
    return calls


def test_c_kernel_calls_match_stats(tmp_path, monkeypatch):
    k1 = count_calls(monkeypatch, "poisson_apply_separable")
    k2 = count_calls(monkeypatch, "zblocked_helmholtz_apply")
    k3 = count_calls(monkeypatch, "convection3d_apply")
    port, _ = run_port(config(tmp_path, "port"))
    assert hasattr(port.convect, "inv_dl")        # K3
    assert hasattr(port.A_momentum, "vecs")       # K2a
    hist = port.stats_history
    assert k1[0] == sum(2 + h["p_iters"] for h in hist)
    # make_fdm_solver applies A twice, then once per refinement pass
    assert k2[0] == sum(3 * (2 + h["v_iters"]) for h in hist)
    assert k3[0] == NSTEPS  # one launch forms the three components


def test_d_stencil_closures_agree(tmp_path, jax_f64):
    port, stats = run_port(config(tmp_path, "port", disablePallas=True))
    assert not hasattr(port.convect, "inv_dl")
    assert stats == jax_f64[1]
    assert_fields_close(fields(port.state), fields(jax_f64[0]), 1e-9)
