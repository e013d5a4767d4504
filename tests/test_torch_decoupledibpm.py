"""The 2D decoupled-IBPM slice as a whole: the port against the JAX
package on the flagship case cut to 32^2 and 24 body points
(__graft_entry__._cylinder_config).  The JAX solver runs as its tests run
it on the CPU, its Poisson residual through the Pallas kernel in interpret
mode; the port's through the K1 wrapper, i.e. its plain twin on the CPU.

(a) 20 steps in float64: fields to 1e-9 of their maximum, every stat equal
(b) the same in float32: fields to 1e-4, ok flags equal
(c) 30 JAX steps, state carried over by convert.state_from_numpy, then 5
    more steps on each package, to the tolerances of (a)
(d) the CLIs on one case directory write matching iterations and forces
    logs
"""

import os

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _cylinder_config
from petibm_tpu.solvers.decoupledibpm import DecoupledIBPMSolver as JaxSolver
from petibm_tpu_torch.convert import state_from_numpy, state_to_numpy
from petibm_tpu_torch.solvers.decoupledibpm import (
    DecoupledIBPMSolver as TorchSolver)

torch.set_num_threads(2)

STAT_KEYS = ("v_iters", "v_ok", "p_iters", "p_ok", "f_iters", "f_ok")


def config(tmp_path, name, dtype="float64", **params):
    d = tmp_path / name
    (d / "output").mkdir(parents=True)
    (d / "logs").mkdir()
    cfg = _cylinder_config(32, str(d))
    cfg["parameters"].update(dtype=dtype, **params)
    return cfg


def host_stats(stats, keys=STAT_KEYS):
    s = jax.device_get(stats)
    return {k: (int(s[k]) if k.endswith("_iters") else bool(s[k]))
            for k in keys}


def fields(state):
    """The compared fields of a JAX (numpy) or port state."""
    if isinstance(state["p"], torch.Tensor):
        state = state_to_numpy(state)
    state = jax.device_get(state)
    return {"u": state["q"]["u"], "v": state["q"]["v"], "p": state["p"],
            "dP": state["dP"], "f": state["f"], "df": state["df"]}


def assert_fields_close(got, want, tol):
    for key, w in want.items():
        w = np.asarray(w)
        g = np.asarray(got[key])
        assert g.shape == w.shape, key
        scale = max(np.abs(w).max(), 1e-300)
        err = np.abs(g - w).max() / scale
        assert err <= tol, (key, err)


def run_jax(solver, state, n):
    stats = []
    for _ in range(n):
        state, s = solver._step_fn(state)
        stats.append(host_stats(s))
    return state, stats


def run_port(solver, n):
    first = len(solver.stats_history)
    for _ in range(n):
        solver.advance()
    return [{k: h[k] for k in STAT_KEYS}
            for h in solver.stats_history[first:]]


@pytest.fixture(scope="module")
def jax_f64(tmp_path_factory):
    """One JAX float64 run: the state and stats after 20 steps, the state
    after 30 and the stats and state after 35."""
    tmp = tmp_path_factory.mktemp("jax_f64")
    solver = JaxSolver(config(tmp, "run"))
    s20, stats20 = run_jax(solver, solver.state, 20)
    s30, _ = run_jax(solver, s20, 10)
    s35, stats35 = run_jax(solver, s30, 5)
    solver.close()
    return {"s20": jax.device_get(s20), "stats20": stats20,
            "s30": jax.device_get(s30), "s35": jax.device_get(s35),
            "stats35": stats35}


def test_a_twenty_steps_float64(tmp_path, jax_f64):
    port = TorchSolver(config(tmp_path, "port"), device="cpu")
    stats = run_port(port, 20)
    port.close()
    assert stats == jax_f64["stats20"]
    assert_fields_close(fields(port.state), fields(jax_f64["s20"]), 1e-9)


def test_b_twenty_steps_float32(tmp_path):
    jsolver = JaxSolver(config(tmp_path, "jax", dtype="float32"))
    jstate, jstats = run_jax(jsolver, jsolver.state, 20)
    jsolver.close()
    port = TorchSolver(config(tmp_path, "port", dtype="float32"),
                       device="cpu")
    stats = run_port(port, 20)
    port.close()
    assert port.state["p"].dtype == torch.float32
    assert [{k: s[k] for k in s if k.endswith("_ok")} for s in stats] == [
        {k: s[k] for k in s if k.endswith("_ok")} for s in jstats]
    assert_fields_close(fields(port.state), fields(jstate), 1e-4)


def test_c_state_carried_over_from_jax(tmp_path, jax_f64):
    port = TorchSolver(config(tmp_path, "port"), device="cpu")
    port.state = state_from_numpy(jax_f64["s30"], "cpu", torch.float64)
    assert sorted(port.state) == sorted(jax_f64["s30"])
    assert sorted(port.state["bc"]) == sorted(jax_f64["s30"]["bc"])
    stats = run_port(port, 5)
    port.close()
    assert stats == jax_f64["stats35"]
    assert_fields_close(fields(port.state), fields(jax_f64["s35"]), 1e-9)


def test_convert_round_trip(jax_f64):
    tree = jax_f64["s30"]
    state = state_from_numpy(tree, "cpu", torch.float64)
    back = state_to_numpy(state)
    assert isinstance(back["conv"], tuple) and len(back["conv"]) == 2
    flat_a, tdef_a = jax.tree_util.tree_flatten(tree)
    flat_b, tdef_b = jax.tree_util.tree_flatten(back)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)


def _write_case(directory, cfg):
    import yaml

    os.makedirs(directory)
    body = os.path.join(directory, "circle.body")
    with open(cfg["bodies"][0]["file"]) as src, open(body, "w") as dst:
        dst.write(src.read())
    node = {k: cfg[k] for k in ("mesh", "flow", "parameters")}
    node["bodies"] = [{"type": "points", "file": "circle.body"}]
    with open(os.path.join(directory, "config.yaml"), "w") as fh:
        yaml.safe_dump(node, fh)


def test_d_cli_logs_match(tmp_path, capsys):
    from petibm_tpu.cli.decoupledibpm import main as jax_main
    from petibm_tpu_torch.cli.decoupledibpm import main as port_main

    cfg = config(tmp_path, "src", nt=12, nsave=5, nrestart=100)
    _write_case(str(tmp_path / "jax_case"), cfg)
    _write_case(str(tmp_path / "port_case"), cfg)
    assert jax_main(["-directory", str(tmp_path / "jax_case")]) == 0
    assert port_main(["-directory", str(tmp_path / "port_case"),
                      "-device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[time step 12]" in out
    for name, iter_cols in (("iterations-0.txt", (1, 3, 5)),
                            ("forces-0.txt", ())):
        want = np.loadtxt(tmp_path / "jax_case" / "output" / name)
        got = np.loadtxt(tmp_path / "port_case" / "output" / name)
        assert got.shape == want.shape == (12, want.shape[1])
        if name.startswith("iterations"):
            assert want.shape[1] == 7
            np.testing.assert_array_equal(got[:, 0], want[:, 0])
            np.testing.assert_array_equal(got[:, iter_cols],
                                          want[:, iter_cols])
            # residuals: printed to 6 digits, near the rounding floor
            np.testing.assert_allclose(got[:, 2::2], want[:, 2::2],
                                       rtol=1e-3, atol=1e-12)
        else:
            assert want.shape[1] == 3
            np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-12)


UNSUPPORTED = {
    # in one process a two-device mesh is a configuration error (what a
    # decomposed run leaves out: tests/test_torch_parallel.py)
    "sharding": ({"sharding": {"nDevices": 2}}, "nDevices=2"),
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED) + ["moving"])
def test_unsupported_configs_raise(tmp_path, name):
    cfg = config(tmp_path, "run")
    error = NotImplementedError
    if name == "moving":
        cfg["bodies"][0]["kinematics"] = {"type": "oscillation"}
        item = "RigidKinematicsSolver"
    else:
        params, item = UNSUPPORTED[name]
        cfg["parameters"].update(params)
        error = ValueError
    with pytest.raises(error, match=item):
        TorchSolver(cfg, device="cpu")


KRYLOV_CONFIGS = {
    # CG + Jacobi momentum solve (an explicit velocity pc)
    "velocity_krylov": {"velocitySolver": {"type": "CPU", "pc": "jacobi"}},
    # CG + Jacobi pressure solve on the stencil closure
    "poisson_krylov": {"poissonSolver": {"type": "CPU", "pc": "jacobi"}},
    # CG preconditioned by the FDM pseudo-inverse, K1 as its operator
    "fdm_pcg": {"fdm": {"mode": "pcg"}},
}


@pytest.mark.parametrize("name", sorted(KRYLOV_CONFIGS))
def test_krylov_configs_match_jax(tmp_path, name):
    """The Krylov solve options: 5 steps equal the JAX package's in
    float64, fields to 1e-9 and every stat."""
    params = KRYLOV_CONFIGS[name]
    jsolver = JaxSolver(config(tmp_path, "jax", **params))
    state, stats = run_jax(jsolver, jsolver.state, 5)
    jsolver.close()
    port = TorchSolver(config(tmp_path, "port", **params), device="cpu")
    port_stats = run_port(port, 5)
    port.close()
    assert port_stats == stats
    which = "p" if name != "velocity_krylov" else "v"
    assert any(s[f"{which}_iters"] > 0 for s in stats)  # Krylov iterates
    assert_fields_close(fields(port.state), fields(jax.device_get(state)),
                        1e-9)


def cavity3d_config(tmp_path, name, **params):
    d = tmp_path / name
    cfg = {
        "directory": str(d), "output": str(d / "output"),
        "logs": str(d / "logs"),
        "mesh": [{"direction": ax, "start": 0.0, "subDomains": [
            {"end": 1.0, "cells": n, "stretchRatio": r}]}
            for ax, n, r in (("x", 8, 1.1), ("y", 7, 1.0), ("z", 6, 0.95))],
        "flow": {"nu": 0.01, "initialVelocity": [0.0, 0.0, 0.0],
                 "boundaryConditions": [
                     {"location": loc,
                      "u": ["DIRICHLET", 1.0 if loc == "zPlus" else 0.0],
                      "v": ["DIRICHLET", 0.0], "w": ["DIRICHLET", 0.0]}
                     for loc in ("xMinus", "xPlus", "yMinus", "yPlus",
                                 "zMinus", "zPlus")]},
        "parameters": {"dt": 0.01, "nt": 4, "nsave": 100, "nrestart": 100,
                       "dtype": "float64", **params},
    }
    return cfg


def test_navierstokes_3d_stencil_path_matches_jax(tmp_path):
    """3D with the hand kernels on runs K3 and K2a (their twins on the
    CPU) and equals the JAX package's stencil-closure (disablePallas) run;
    so does the port's own disablePallas run."""
    from petibm_tpu.solvers.navierstokes import NavierStokesSolver as JaxNS
    from petibm_tpu_torch.solvers.navierstokes import NavierStokesSolver

    keys = ("v_iters", "v_ok", "p_iters", "p_ok")
    jsolver = JaxNS(cavity3d_config(tmp_path, "jax", disablePallas=True))
    state, stats = jsolver.state, []
    for _ in range(4):
        state, s = jsolver._step_fn(state)
        stats.append(host_stats(s, keys))
    jsolver.close()
    want = jax.device_get(state)
    for name, disable in (("kernels", False), ("stencil", True)):
        port = NavierStokesSolver(
            cavity3d_config(tmp_path, name, disablePallas=disable),
            device="cpu")
        assert hasattr(port.convect, "inv_dl") != disable  # K3
        assert hasattr(port.A_momentum, "vecs") != disable  # K2a
        port.run()
        port.close()
        assert [{k: h[k] for k in keys} for h in port.stats_history] == stats
        for key in ("u", "v", "w"):
            assert_fields_close({key: port.state["q"][key].numpy()},
                                {key: want["q"][key]}, 1e-9)
        assert_fields_close({"p": port.state["p"].numpy()},
                            {"p": want["p"]}, 1e-9)


def test_divergence_policy_and_logs(tmp_path):
    """A failing solve aborts at the log flush with the step named; the
    iterations log is still written."""
    from petibm_tpu_torch.linalg.krylov import SolverDivergedError

    cfg = config(tmp_path, "run", nt=3, nsave=100,
                 velocitySolver={"type": "CPU", "atol": 1e-30, "rtol": 0.0,
                                 "max_it": 1})
    solver = TorchSolver(cfg, device="cpu")
    with pytest.raises(SolverDivergedError, match="velocity solver diverged"):
        solver.run()
    lines = open(solver.iter_log_path).read().splitlines()
    assert len(lines) == 3 and lines[0].split("\t")[0] == "1"
    solver.close()
