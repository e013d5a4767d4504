"""The multigrid-preconditioned CG pressure path as a whole: the port
against the JAX package with ``fdm: false`` (and with BN = 2, which has
no FDM solve), through the solvers' steps.

Cases (small cuts of the cells the port runs):
- ``cylinder``: 20 steps of the 32^2 decoupled-IBPM cylinder
  (``__graft_entry__._cylinder_config``): K4/K5 on every level, K1 as the
  CG operator and the V-cycle's level-0 residual;
- ``cylinder_yperiodic``: the same cylinder with periodic y walls, 5
  steps: K6/K7 in 2D (a periodic 2D level keeps the closure operator);
- ``cavity_bn2``: 5 steps of a 32^2 lid-driven cavity with BN = 2 on the
  plain solver: K4/K5, the closure operator (BN order 2);
- ``sphere``: 5 steps of the 24x20x16 stretched sphere (100 points): 3D
  K4/K5, K1, the CG momentum solve on K2a, K3;
- ``tgv``: 5 steps of the 16^3 Taylor-Green vortex: K6/K7 on every level,
  K2b as the CG operator and level-0 residual, BiCGStab on K2a, K3.

The JAX side runs its MG as on its chip in 2D (``use_pcr`` with the Pallas
sweep and PCR kernels in interpret mode; asserted), and its CPU default in
3D (the unfused LAPACK sweep: the interpret-mode 3D kernels take minutes to
compile inside the step).  The port runs the kernels' wrappers, i.e. their
plain twins on CPU tensors.

(a) float64: every compared field to 1e-9 of its maximum, every stat equal
    (``p_iters`` included)
(b) float32: the fields to 1e-4, ok flags equal (the TGV's dP, fixed only
    to the solve's tolerance, to 1e-4 of p's maximum)
(c) the wrappers are called per step as the stats imply (the counts
    ``chip_smoke.py`` holds the CUDA launches to): sweeps_per_vcycle() x
    (p_iters + 1) sweeps, 2 (1 + p_iters) level-0 applies
"""

import os

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _cylinder_config
from petibm_tpu.linalg import pallas_pcr, pallas_sweep
from petibm_tpu.solvers.decoupledibpm import DecoupledIBPMSolver as JaxIBPM
from petibm_tpu.solvers.navierstokes import NavierStokesSolver as JaxNS
from petibm_tpu_torch.convert import state_to_numpy
from petibm_tpu_torch.linalg import mg as mg_mod
from petibm_tpu_torch.operators import cuda_stencil as cs
from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver
from petibm_tpu_torch.solvers.navierstokes import NavierStokesSolver
from test_mesh import cavity_config
from test_torch_decoupledibpm import assert_fields_close
from test_torch_sphere3d import config as sphere_config
from test_torch_tgv3d import config as tgv_config

torch.set_num_threads(2)


def cylinder(tmp_path, name, dtype, yperiodic=False):
    d = tmp_path / name
    (d / "output").mkdir(parents=True)
    (d / "logs").mkdir()
    cfg = _cylinder_config(32, str(d))
    cfg["parameters"].update(dtype=dtype, fdm=False)
    if yperiodic:
        for bc in cfg["flow"]["boundaryConditions"]:
            if bc["location"] in ("yMinus", "yPlus"):
                bc["u"] = ["PERIODIC", 0.0]
                bc["v"] = ["PERIODIC", 0.0]
    return cfg


def cavity(tmp_path, name, dtype):
    d = tmp_path / name
    cfg = cavity_config(32, 32)
    cfg["flow"]["boundaryConditions"][3]["u"] = ["DIRICHLET", 1.0]  # lid
    cfg.update(directory=str(d), output=str(d / "output"),
               logs=str(d / "logs"))
    cfg["parameters"] = {
        "dt": 0.01, "nt": 5, "nsave": 100, "nrestart": 100, "BN": 2,
        "dtype": dtype, "convection": "ADAMS_BASHFORTH_2",
        "diffusion": "CRANK_NICOLSON",
        "velocitySolver": {"type": "CPU"}, "poissonSolver": {"type": "CPU"}}
    return cfg


def sphere(tmp_path, name, dtype):
    return sphere_config(tmp_path, name, dtype=dtype, fdm=False)


def tgv(tmp_path, name, dtype):
    return tgv_config(tmp_path, name, dtype=dtype, fdm=False)


# name: (config, JAX solver, port solver, steps, compared fields, stat keys)
IBM_KEYS = ("v_iters", "v_ok", "p_iters", "p_ok", "f_iters", "f_ok")
NS_KEYS = IBM_KEYS[:4]
CASES = {
    "cylinder": (cylinder, JaxIBPM, DecoupledIBPMSolver, 20, "uvpf",
                 IBM_KEYS),
    "cylinder_yperiodic": (
        lambda t, n, dt: cylinder(t, n, dt, yperiodic=True), JaxIBPM,
        DecoupledIBPMSolver, 5, "uvpf", IBM_KEYS),
    "cavity_bn2": (cavity, JaxNS, NavierStokesSolver, 5, "uvp", NS_KEYS),
    "sphere": (sphere, JaxIBPM, DecoupledIBPMSolver, 5, "uvwpf", IBM_KEYS),
    "tgv": (tgv, JaxNS, NavierStokesSolver, 5, "uvwp", NS_KEYS),
}


def compared(state, keys):
    if isinstance(state["p"], torch.Tensor):
        state = state_to_numpy(state)
    state = jax.device_get(state)
    out = {k: state["q"][k] for k in "uvw" if k in keys}
    out.update({k: state[k] for k in ("p", "f") if k in keys})
    out["dP"] = state["dP"]
    return out


def count_pallas(monkeypatch):
    """Count the JAX Pallas sweep and PCR calls traced by the JAX step."""
    calls = {}
    for mod, names in ((pallas_sweep, ("fused_sweep", "fused_sweep_blocked")),
                       (pallas_pcr, ("pcr_pallas", "pcr_pallas_blocked"))):
        for name in names:
            real = getattr(mod, name)
            calls[name] = 0

            def counted(*args, _real=real, _name=name, **kwargs):
                calls[_name] += 1
                return _real(*args, **kwargs)

            monkeypatch.setattr(mod, name, counted)
    return calls


def run_jax(case, tmp_path, dtype, monkeypatch):
    make, jax_cls, _, nsteps, _, keys = CASES[case]
    cfg = make(tmp_path, "jax", dtype)
    solver = jax_cls(cfg)
    assert getattr(solver, "poisson_fdm", None) is None  # the MG-CG path
    two_d = solver.mesh.dim == 2
    solver.poisson_mg.use_pcr = two_d
    solver.poisson_mg._pallas_interpret = two_d
    calls = count_pallas(monkeypatch)
    state, stats = solver.state, []
    for _ in range(nsteps):
        state, s = solver._step_fn(state)
        s = jax.device_get(s)
        stats.append({k: (int(s[k]) if k.endswith("_iters") else bool(s[k]))
                      for k in keys})
    solver.close()
    if two_d:
        # the JAX side really ran its Pallas kernels (interpret mode)
        periodic = any(solver.mesh.periodic)
        ran = (calls["pcr_pallas"] + calls["pcr_pallas_blocked"] if periodic
               else calls["fused_sweep"] + calls["fused_sweep_blocked"])
        assert ran > 0, calls
    return jax.device_get(state), stats


def count_calls(monkeypatch):
    """Count the calls of every kernel wrapper the step reaches."""
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

        monkeypatch.setattr(mod, name, counted)
    return calls


def implied_calls(case, solver) -> dict:
    """The wrapper calls the stats imply (``chip_smoke.py``'s formulas)."""
    hist = solver.stats_history
    mg = solver.poisson_mg
    vcycles = sum(1 + h["p_iters"] for h in hist)
    periodic = any(solver.mesh.periodic)
    want = {"fused_sweep": 0 if periodic else mg.sweeps_per_vcycle() * vcycles,
            "pcr": mg.sweeps_per_vcycle() * vcycles if periodic else 0,
            "poisson_apply_separable": 0, "zblocked_helmholtz_apply": 0,
            "convection3d_apply": 0}
    if case in ("cylinder", "sphere"):
        # the CG operator, A(x0) + one per iteration, and the V-cycle's
        # level-0 residual, one per V-cycle
        want["poisson_apply_separable"] = 2 * vcycles
    if case == "sphere":
        # CG momentum solve: A(x0) + one per iteration, per component
        want["zblocked_helmholtz_apply"] = sum(3 * (1 + h["v_iters"])
                                               for h in hist)
        want["convection3d_apply"] = len(hist)
    if case == "tgv":
        # BiCGStab: A once, then twice per iteration, per component (K2a);
        # K2b as the CG operator and level-0 residual
        want["zblocked_helmholtz_apply"] = (
            sum(3 * (1 + 2 * h["v_iters"]) for h in hist) + 2 * vcycles)
        want["convection3d_apply"] = len(hist)
    return want


@pytest.mark.parametrize("case", sorted(CASES))
def test_float64_equals_jax_and_kernel_calls_match_stats(case, tmp_path,
                                                         monkeypatch):
    state, stats = run_jax(case, tmp_path, "float64", monkeypatch)
    make, _, port_cls, nsteps, fields, keys = CASES[case]
    calls = count_calls(monkeypatch)
    port = port_cls(make(tmp_path, "port", "float64"), device="cpu")
    assert port.poisson_mg.kernels and getattr(port, "poisson_fdm",
                                               None) is None
    for _ in range(nsteps):
        port.advance()
    port.close()
    port_stats = [{k: h[k] for k in keys} for h in port.stats_history]
    assert port_stats == stats
    assert all(s["p_iters"] > 0 for s in stats)  # CG + V-cycles iterate
    assert_fields_close(compared(port.state, fields),
                        compared(state, fields), 1e-9)
    assert calls == implied_calls(case, port)


@pytest.mark.parametrize("case", sorted(CASES))
def test_float32_matches_jax(case, tmp_path, monkeypatch):
    state, stats = run_jax(case, tmp_path, "float32", monkeypatch)
    make, _, port_cls, nsteps, fields, keys = CASES[case]
    port = port_cls(make(tmp_path, "port", "float32"), device="cpu")
    for _ in range(nsteps):
        port.advance()
    port.close()
    assert port.state["p"].dtype == torch.float32
    oks = [{k: h[k] for k in keys if k.endswith("_ok")}
           for h in port.stats_history]
    assert oks == [{k: s[k] for k in s if k.endswith("_ok")} for s in stats]
    got, want = compared(port.state, fields), compared(state, fields)
    dp_err = np.abs(got.pop("dP") - want.pop("dP")).max()
    assert dp_err <= 1e-4 * np.abs(want["p"]).max()
    assert_fields_close(got, want, 1e-4)


def test_disable_pallas_runs_the_twins(tmp_path):
    """``disablePallas`` turns K4-K7 off with K1-K3: the same steps, no
    wrapper of a hand kernel in the path."""
    runs = {}
    for name, disable in (("kernels", False), ("twins", True)):
        cfg = cylinder(tmp_path, name, "float64")
        cfg["parameters"].update(disablePallas=disable, nt=3)
        solver = DecoupledIBPMSolver(cfg, device="cpu")
        assert solver.poisson_mg.kernels != disable
        assert (solver.poisson_mg._fused_apply0 is None) == disable
        solver.run()
        solver.close()
        runs[name] = solver
    assert ([h["p_iters"] for h in runs["kernels"].stats_history]
            == [h["p_iters"] for h in runs["twins"].stats_history])
    for key in ("u", "v"):
        a = runs["kernels"].state["q"][key].numpy()
        b = runs["twins"].state["q"][key].numpy()
        assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()


def _write_case(directory, cfg):
    import yaml

    os.makedirs(directory)
    node = {k: cfg[k] for k in ("mesh", "flow", "parameters")}
    with open(os.path.join(directory, "config.yaml"), "w") as fh:
        yaml.safe_dump(node, fh)


def test_ns_cli_runs_mgcg(tmp_path, capsys):
    """``python -m petibm_tpu_torch.cli.navierstokes`` on a BN = 2 cavity
    (the MG-CG path) writes the JAX CLI's iteration counts."""
    from petibm_tpu.cli.navierstokes import main as jax_main
    from petibm_tpu_torch.cli.navierstokes import main as port_main

    cfg = cavity(tmp_path, "src", "float64")
    for name in ("jax_case", "port_case"):
        _write_case(str(tmp_path / name), cfg)
    assert jax_main(["-directory", str(tmp_path / "jax_case")]) == 0
    assert port_main(["-directory", str(tmp_path / "port_case"),
                      "-device", "cpu"]) == 0
    assert "[time step 5]" in capsys.readouterr().out
    want = np.loadtxt(tmp_path / "jax_case" / "output" / "iterations-0.txt")
    got = np.loadtxt(tmp_path / "port_case" / "output" / "iterations-0.txt")
    assert got.shape == want.shape == (5, 5)
    np.testing.assert_array_equal(got[:, (0, 1, 3)], want[:, (0, 1, 3)])
    assert (got[:, 3] > 0).all()
