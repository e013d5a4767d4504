"""Moving bodies: the port's ``RigidKinematicsSolver`` against the JAX
package's on the 32^2 decoupled cylinder (``__graft_entry__.
_cylinder_config``: uniform stream, convective outlet, 24 points) whose
body oscillates in line, f = 1, D = 1, KC = 2 (Am = 0.318, a cell and a
half at t = 0.1).  At that motion the refinement against the setup-time
inverse exits above tolerance at 8 of the 20 steps, so both branches of
the force solve run.

(a) 20 steps in float64: every stat equal, the fallback branch taken at
    the same steps, fields u, v, p, f to 1e-9 of their maximum and
    ``state["t"]`` bit-equal; (b) the same in float32: ok flags and
    branches equal, fields to 1e-4, ``state["t"]`` bit-equal;
(c) ``forcesSolver.max_it: 0`` (no refinement pass, so every step falls
    back), float64, to the tolerances of (a);
(d) a JAX state after 10 steps (``t`` included) carried over by
    ``convert.state_from_numpy``, then 10 more steps on each package;
(e) the body files ``<name>_<step>.2D`` equal to 1e-12;
(f) the CLIs write matching iterations and forces logs;
(g) ``chip_smoke.py``'s dict of the oscillating-cylinder example is the
    example.
"""

import os

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _cylinder_config
from petibm_tpu.solvers.rigidkinematics import RigidKinematicsSolver as JaxSolver
from petibm_tpu_torch.convert import state_from_numpy, state_to_numpy
from petibm_tpu_torch.solvers.rigidkinematics import (
    RigidKinematicsSolver as TorchSolver)
from test_torch_decoupledibpm import (STAT_KEYS, _write_case,
                                      assert_fields_close, host_stats)

torch.set_num_threads(2)

KINEMATICS = {"type": "oscillation", "f": 1.0, "D": 1.0, "KC": 2.0}
NSTEPS = 20


def config(tmp_path, name, dtype="float64", **params):
    d = tmp_path / name
    (d / "output").mkdir(parents=True)
    (d / "logs").mkdir()
    cfg = _cylinder_config(32, str(d))
    cfg["parameters"].update(dict(dtype=dtype, nt=NSTEPS), **params)
    cfg["bodies"][0]["kinematics"] = dict(KINEMATICS)
    return cfg


def record_branches(monkeypatch) -> list:
    """Patch ``jax.lax.cond`` so that the JAX force solve's cond records,
    step by step, 1 where its ``fallback`` branch runs (call before the
    JAX step is first traced)."""
    taken = []
    real = jax.lax.cond

    def cond(pred, true_fun, false_fun, *operands):
        if getattr(false_fun, "__name__", "") == "fallback":
            jax.debug.callback(lambda p: taken.append(int(not p)), pred)
        return real(pred, true_fun, false_fun, *operands)

    monkeypatch.setattr(jax.lax, "cond", cond)
    return taken


def run_jax(solver, state, n):
    stats = []
    for _ in range(n):
        state, s = solver._step_fn(state)
        stats.append(host_stats(s))
    return jax.device_get(state), stats


def run_port(solver, n):
    """n steps; the stats and, per step, 1 where the force solve fell back."""
    first, branches = len(solver.stats_history), []
    for _ in range(n):
        before = solver.fallbacks
        solver.advance()
        branches.append(solver.fallbacks - before)
    return ([{k: h[k] for k in STAT_KEYS}
             for h in solver.stats_history[first:]], branches)


def fields(state):
    if isinstance(state["p"], torch.Tensor):
        state = state_to_numpy(state)
    state = jax.device_get(state)
    return {"u": state["q"]["u"], "v": state["q"]["v"], "p": state["p"],
            "f": state["f"]}


def assert_t_equal(port_state, jax_state, dtype):
    t_port = port_state["t"].numpy()
    t_jax = np.asarray(jax_state["t"])
    assert t_port.shape == t_jax.shape == ()
    assert t_port.dtype == t_jax.dtype == np.dtype(dtype)
    assert t_port.tobytes() == t_jax.tobytes()


@pytest.fixture(scope="module")
def jax_f64(tmp_path_factory):
    """One JAX float64 run: its state after 10 steps, and the stats,
    branches and state after 20."""
    tmp = tmp_path_factory.mktemp("jax_f64")
    mp = pytest.MonkeyPatch()
    branches = record_branches(mp)
    solver = JaxSolver(config(tmp, "run"))
    s10, stats10 = run_jax(solver, solver.state, 10)
    s20, stats20 = run_jax(solver, s10, NSTEPS - 10)
    solver.close()
    mp.undo()
    return {"s10": s10, "s20": s20, "stats": stats10 + stats20,
            "branches": list(branches)}


def test_a_twenty_steps_float64(tmp_path, jax_f64):
    port = TorchSolver(config(tmp_path, "port"), device="cpu")
    stats, branches = run_port(port, NSTEPS)
    port.close()
    assert stats == jax_f64["stats"]
    assert branches == jax_f64["branches"]
    # both branches of the force solve ran
    assert 0 < sum(branches) < NSTEPS
    assert port.fallbacks == sum(branches)
    assert_fields_close(fields(port.state), fields(jax_f64["s20"]), 1e-9)
    assert_t_equal(port.state, jax_f64["s20"], "float64")


def test_b_twenty_steps_float32(tmp_path, monkeypatch):
    jbranches = record_branches(monkeypatch)
    jsolver = JaxSolver(config(tmp_path, "jax", dtype="float32"))
    jstate, jstats = run_jax(jsolver, jsolver.state, NSTEPS)
    jsolver.close()
    port = TorchSolver(config(tmp_path, "port", dtype="float32"),
                       device="cpu")
    stats, branches = run_port(port, NSTEPS)
    port.close()
    assert port.state["p"].dtype == torch.float32
    assert [{k: s[k] for k in s if k.endswith("_ok")} for s in stats] == [
        {k: s[k] for k in s if k.endswith("_ok")} for s in jstats]
    assert branches == jbranches
    assert_fields_close(fields(port.state), fields(jstate), 1e-4)
    assert_t_equal(port.state, jstate, "float32")


def test_c_forced_fallback(tmp_path, monkeypatch):
    """``max_it: 0`` stops the refinement after its direct pass (the
    stopping rule ``it < max_it``): above tolerance at every step, so
    every step takes the dense direct solve, with ``iters`` 0."""
    params = {"forcesSolver": {"type": "CPU", "max_it": 0}}
    jbranches = record_branches(monkeypatch)
    jsolver = JaxSolver(config(tmp_path, "jax", **params))
    jstate, jstats = run_jax(jsolver, jsolver.state, NSTEPS)
    jsolver.close()
    port = TorchSolver(config(tmp_path, "port", **params), device="cpu")
    stats, branches = run_port(port, NSTEPS)
    port.close()
    assert jbranches == branches == [1] * NSTEPS
    assert stats == jstats
    assert all(s["f_iters"] == 0 and s["f_ok"] for s in stats)
    assert_fields_close(fields(port.state), fields(jstate), 1e-9)
    assert_t_equal(port.state, jstate, "float64")


def test_d_state_carried_over_from_jax(tmp_path, jax_f64):
    port = TorchSolver(config(tmp_path, "port"), device="cpu")
    port.state = state_from_numpy(jax_f64["s10"], "cpu", torch.float64)
    assert sorted(port.state) == sorted(jax_f64["s10"])
    assert port.state["t"].shape == ()
    stats, branches = run_port(port, NSTEPS - 10)
    port.close()
    assert stats == jax_f64["stats"][10:]
    assert branches == jax_f64["branches"][10:]
    assert_fields_close(fields(port.state), fields(jax_f64["s20"]), 1e-9)
    assert_t_equal(port.state, jax_f64["s20"], "float64")


def test_convert_round_trip_carries_t(jax_f64):
    tree = jax_f64["s10"]
    back = state_to_numpy(state_from_numpy(tree, "cpu", torch.float64))
    assert sorted(back) == sorted(tree)
    assert back["t"].shape == () and back["t"] == np.asarray(tree["t"])
    for key in ("p", "f", "df", "dP"):
        np.testing.assert_array_equal(back[key], np.asarray(tree[key]))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_e_body_files_match(tmp_path, dtype):
    """run() writes <name>_<step>.2D at the start and every nsave steps;
    the port's equal the JAX package's to 1e-12, and the body moves in x
    only."""
    params = dict(dtype=dtype, nt=6, nsave=3, nrestart=100)
    for name, make in (("jax", lambda c: JaxSolver(c)),
                       ("port", lambda c: TorchSolver(c, device="cpu"))):
        cfg = config(tmp_path, name, **params)
        cfg["bodies"][0]["name"] = "circle"
        solver = make(cfg)
        solver.run()
        solver.close()
    files = ("circle_0000000.2D", "circle_0000003.2D", "circle_0000006.2D")
    for name in files:
        want = np.loadtxt(tmp_path / "jax" / "output" / name)
        got = np.loadtxt(tmp_path / "port" / "output" / name)
        assert got.shape == want.shape == (24, 2)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    first, last = (np.loadtxt(tmp_path / "port" / "output" / files[k])
                   for k in (0, -1))
    assert abs(first[:, 0].mean() - last[:, 0].mean()) > 1e-3
    np.testing.assert_array_equal(first[:, 1], last[:, 1])


def test_f_cli_logs_match(tmp_path, capsys):
    from petibm_tpu.cli.rigidkinematics import main as jax_main
    from petibm_tpu_torch.cli.rigidkinematics import main as port_main

    import yaml

    cfg = config(tmp_path, "src", nt=12, nsave=5, nrestart=100)
    for case in ("jax_case", "port_case"):
        _write_case(str(tmp_path / case), cfg)
        path = tmp_path / case / "config.yaml"
        node = yaml.safe_load(path.read_text())
        node["bodies"][0]["kinematics"] = dict(KINEMATICS)
        path.write_text(yaml.safe_dump(node))
    assert jax_main(["-directory", str(tmp_path / "jax_case")]) == 0
    assert port_main(["-directory", str(tmp_path / "port_case"),
                      "-device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[time step 12]" in out and "fell back" in out
    for name in ("iterations-0.txt", "forces-0.txt"):
        want = np.loadtxt(tmp_path / "jax_case" / "output" / name)
        got = np.loadtxt(tmp_path / "port_case" / "output" / name)
        assert got.shape == want.shape
        if name.startswith("iterations"):
            assert want.shape == (12, 7)
            np.testing.assert_array_equal(got[:, (0, 1, 3, 5)],
                                          want[:, (0, 1, 3, 5)])
            np.testing.assert_allclose(got[:, 2::2], want[:, 2::2],
                                       rtol=1e-3, atol=1e-12)
        else:
            assert want.shape == (12, 3)
            np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-12)
    for step in (0, 5, 10):
        name = f"body00_{step:07d}.2D"
        np.testing.assert_allclose(
            np.loadtxt(tmp_path / "port_case" / "output" / name),
            np.loadtxt(tmp_path / "jax_case" / "output" / name),
            rtol=0, atol=1e-12)


def test_g_chip_smoke_oscillating_config_is_the_example(tmp_path):
    """chip_smoke.py's dict of examples/decoupledibpm/
    oscillatingcylinder2dRe100 (the card need not have pyyaml) holds the
    example's mesh, flow, time stepping, delta kernel, body and
    kinematics, and its resolved solver settings."""
    from chip_smoke import OSC_DIR, oscillating_config
    from petibm_tpu_torch.config import load_config, solver_config

    got = oscillating_config(str(tmp_path / "smoke"))
    want = load_config(directory=OSC_DIR)
    assert got["mesh"] == want["mesh"]
    assert got["flow"] == want["flow"]
    for key in ("dt", "nt", "nsave", "nrestart", "convection", "diffusion",
                "delta"):
        assert got["parameters"][key] == want["parameters"][key], key
    (gb,), (wb,) = got["bodies"], want["bodies"]
    assert os.path.basename(gb["file"]) == wb["file"]
    assert gb["name"] == wb["name"]
    assert gb["kinematics"] == wb["kinematics"]
    for role in ("velocity", "poisson", "forces"):
        a, b = solver_config(got, role), solver_config(want, role)
        for key in ("type", "atol", "rtol", "max_it", "pc", "backend"):
            assert a.get(key) == b.get(key), (role, key)
