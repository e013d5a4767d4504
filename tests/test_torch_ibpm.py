"""The coupled IBPM slice as a whole: the port's ``IBPMSolver`` against
the JAX package's on ``test_ibm.py``'s ``ib_config`` (a 30^2 channel, a
20-point cylinder, 5 steps), the same config for both.

- the block operator M on the same random {p, f} in float64 to 1e-12;
  the port's M dense-probed at 12^2: symmetric, negative semidefinite,
  the constant pressure its nullspace;
- the Schur complement S of the direct solve equal to the one the JAX
  package inverts, in float64 to 1e-12;
- 5 steps in float64 for each coupled solve (the Schur CG, its plain
  refinement, the outer CG with the FDM or the V-cycle (also with the
  pinned pressure) or the probed Jacobi diagonal, the pinned Schur solve,
  BN = 2): fields to 1e-9 of their maximum (the Jacobi variant to bounds
  taken from the JAX package run against itself with its start perturbed
  at rounding level), every stat equal, and the kernel wrappers called as
  the stats imply (K1 once per V-cycle, at its level-0 residual; the coupled
  operator itself is not K1); the same in float32 to 1e-4 with equal ok
  flags;
- a state carried over from JAX (``convert.state_from_numpy``, ``f`` and
  the nested ``dPhi`` included), then 5 more steps on each package;
- the 3D sphere of ``test_torch_sphere3d.py`` (24x20x16, 100 points):
  K2a and K3 in the coupled path;
- the CLIs on one case directory write matching iterations and forces
  logs;
- ``chip_smoke.py``'s Re=550 configuration is the example's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petibm_tpu.solvers.ibpm import IBPMSolver as JaxSolver
from petibm_tpu_torch.convert import state_from_numpy, state_to_numpy
from petibm_tpu_torch.solvers.ibpm import IBPMSolver as TorchSolver
from petibm_tpu_torch.types import Field
from test_ibm import ib_config
from test_torch_decoupledibpm import (_write_case, assert_fields_close,
                                      host_stats)
from test_torch_decoupledibpm import config as cylinder_config
from test_torch_mgcg import count_calls
from test_torch_sphere3d import config as sphere_config

torch.set_num_threads(2)

KEYS = ("v_iters", "v_ok", "p_iters", "p_ok")
NSTEPS = 5

VARIANTS = {
    "schur_pcg": {},
    "schur_direct": {"coupledMode": "direct"},
    "cg_fdm": {"coupledDirect": False},
    "cg_mg": {"fdm": False},
    "pinned_schur": {"poissonSolver": {"type": "GPU"}},
    "pinned_cg_mg": {"poissonSolver": {"type": "GPU"},
                     "coupledDirect": False},
    "bn2": {"BN": 2},
    "cg_jacobi": {"poissonSolver": {"pc": "jacobi"}},
}

#: field bounds of a variant whose solve amplifies rounding past 1e-9:
#: (u, v, p, f to the maxima of each; dp, df to the maxima of p, f).
#: The outer CG with the probed Jacobi pressure block takes 66-111
#: iterations a step at atol 1e-6; the JAX package against itself, its
#: initial velocity perturbed by one ulp at random
#: (``test_cg_jacobi_rounding_sensitivity``), moves u, v, p, f by up to
#: 3.2e-9, 6.4e-9, 8.2e-9, 9.2e-9 and dp, df by 4.0e-8, 3.9e-8 of p, f over
#: four seeds, iteration counts unchanged: so 1e-8 and 5e-8.
ROUNDING_BOUNDS = {"cg_jacobi": (1e-8, 5e-8)}


def config(tmp_path, name, variant="schur_pcg", dtype="float64", n=30,
           nt=NSTEPS):
    d = tmp_path / name
    d.mkdir()
    return ib_config(d, n=n, nt=nt,
                     solver_extra=dict(VARIANTS[variant], dtype=dtype))


def fields(state):
    if isinstance(state["p"], torch.Tensor):
        state = state_to_numpy({k: state[k] for k in ("q", "p", "f",
                                                      "dPhi")})
    state = jax.device_get(state)
    return dict(state["q"], p=state["p"], f=state["f"],
                dp=state["dPhi"]["p"], df=state["dPhi"]["f"])


def run_jax(solver, state, n):
    mg = getattr(solver, "poisson_mg", None)
    if mg is not None and solver.mesh.dim == 2:
        # the V-cycle as on the JAX package's chip (the Pallas sweep in
        # interpret mode), as test_torch_mgcg.py runs it
        mg.use_pcr = True
        mg._pallas_interpret = True
    stats = []
    for _ in range(n):
        state, s = solver._step_fn(state)
        stats.append(host_stats(s, KEYS))
    return jax.device_get(state), stats


def run_port(solver, n):
    first = len(solver.stats_history)
    for _ in range(n):
        solver.advance()
    return [{k: h[k] for k in KEYS} for h in solver.stats_history[first:]]


def random_phi(solver, rng):
    pshape = solver.mesh.shape(Field.P)
    return {"p": rng.standard_normal(pshape),
            "f": rng.standard_normal((solver.bodies.n_pts, solver.mesh.dim))}


def apply_m(solver, phi, to):
    """The coupled operator [D B_N (G p - H f); E B_N (G p - H f)] of
    either package, assembled from the solver's closures as
    ``test_ibm.py::test_ibpm_coupled_operator_symmetric`` does."""
    w = solver.bn(solver._G_combined({k: to(v) for k, v in phi.items()}))
    return {"p": np.asarray(solver.div(w, None, homogeneous=True)),
            "f": np.asarray(solver.delta.interpolate(w, solver._win))}


def test_operator_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    jsolver = JaxSolver(config(tmp_path, "jax"))
    port = TorchSolver(config(tmp_path, "port"), device="cpu")
    for _ in range(2):
        phi = random_phi(port, rng)
        got = apply_m(port, phi, torch.as_tensor)
        want = apply_m(jsolver, phi, jnp.asarray)
        for key in ("p", "f"):
            err = np.abs(got[key] - want[key]).max() / np.abs(want[key]).max()
            assert err <= 1e-12, (key, err)
    jsolver.close()
    port.close()


def test_operator_symmetric_with_constant_nullspace(tmp_path):
    port = TorchSolver(config(tmp_path, "port", n=12), device="cpu")
    pshape = port.mesh.shape(Field.P)
    nP, nF = int(np.prod(pshape)), port.bodies.n_pts * 2

    def apply_flat(v):
        out = apply_m(port, {"p": v[:nP].reshape(pshape),
                             "f": v[nP:].reshape(-1, 2)}, torch.as_tensor)
        return np.concatenate([out["p"].ravel(), out["f"].ravel()])

    eye = np.eye(nP + nF)
    M = np.stack([apply_flat(eye[k]) for k in range(nP + nF)], axis=1)
    np.testing.assert_allclose(M, M.T, atol=1e-11)
    null = np.concatenate([np.ones(nP), np.zeros(nF)])
    np.testing.assert_allclose(M @ null, 0.0, atol=1e-11)
    assert np.linalg.eigvalsh(M)[-1] < 1e-10
    port.close()


@pytest.mark.parametrize("variant", ["schur_pcg", "pinned_schur"])
def test_schur_matrix_matches_jax(tmp_path, monkeypatch, variant):
    """The S the JAX package inverts (caught at its np.linalg.inv) against
    the port's, both symmetrised, in float64."""
    seen = []
    real_inv = np.linalg.inv

    def inv(a):
        seen.append(np.array(a))
        return real_inv(a)

    monkeypatch.setattr(np.linalg, "inv", inv)
    jsolver = JaxSolver(config(tmp_path, "jax", variant))
    jsolver.close()
    monkeypatch.setattr(np.linalg, "inv", real_inv)
    assert len(seen) == 1
    port = TorchSolver(config(tmp_path, "port", variant), device="cpu")
    S = port._schur_matrix()
    port.close()
    assert S.shape == seen[0].shape == (40, 40)
    err = np.abs(S - seen[0]).max() / np.abs(seen[0]).max()
    assert err <= 1e-12, err


def assert_close_for(variant, got, want):
    """Fields to 1e-9 of their maxima, or to the variant's
    ROUNDING_BOUNDS."""
    if variant not in ROUNDING_BOUNDS:
        assert_fields_close(got, want, 1e-9)
        return
    tol, dtol = ROUNDING_BOUNDS[variant]
    got, want = dict(got), dict(want)
    for key, of in (("dp", "p"), ("df", "f")):
        err = np.abs(got.pop(key) - want.pop(key)).max()
        assert err <= dtol * np.abs(want[of]).max(), (key, err)
    assert_fields_close(got, want, tol)


def test_cg_jacobi_rounding_sensitivity(tmp_path):
    """The ground of ROUNDING_BOUNDS["cg_jacobi"]: the JAX package against
    itself, the initial velocity perturbed by one ulp (seed 0), keeps its
    iteration counts but moves the fields past the 1e-9 of the other
    variants, and stays inside the variant's bounds."""
    jsolver = JaxSolver(config(tmp_path, "jax", "cg_jacobi"))
    start = jax.device_get(jsolver.state)
    base, stats = run_jax(jsolver, start, NSTEPS)
    rng = np.random.default_rng(0)
    eps = np.finfo(np.float64).eps
    q = {k: jnp.asarray(np.asarray(v) * (1 + eps * rng.choice(
        [-1, 1], size=np.shape(v)))) for k, v in start["q"].items()}
    pert, pstats = run_jax(jsolver, dict(start, q=q), NSTEPS)
    jsolver.close()
    assert pstats == stats
    got, want = fields(pert), fields(base)
    assert np.abs(got["f"] - want["f"]).max() > 1e-9 * np.abs(want["f"]).max()
    assert_close_for("cg_jacobi", got, want)


def implied_calls(solver) -> dict:
    """The kernel wrapper calls the stats imply: with the V-cycle (BN order
    1, not pinned) K1 once per V-cycle (the level-0 residual; one V-cycle
    per CG iteration and one more) and K4/K5 sweeps_per_vcycle() times;
    no wrapper otherwise in 2D."""
    want = {"fused_sweep": 0, "pcr": 0, "poisson_apply_separable": 0,
            "zblocked_helmholtz_apply": 0, "convection3d_apply": 0}
    mg = getattr(solver, "poisson_mg", None)
    if mg is not None:
        vcycles = sum(1 + h["p_iters"] for h in solver.stats_history)
        want["fused_sweep"] = mg.sweeps_per_vcycle() * vcycles
        if mg._fused_apply0 is not None:
            want["poisson_apply_separable"] = vcycles
    return want


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_float64_matches_jax(variant, tmp_path, monkeypatch):
    jsolver = JaxSolver(config(tmp_path, "jax", variant))
    state, stats = run_jax(jsolver, jsolver.state, NSTEPS)
    jsolver.close()
    calls = count_calls(monkeypatch)
    port = TorchSolver(config(tmp_path, "port", variant), device="cpu")
    port_stats = run_port(port, NSTEPS)
    port.close()
    assert port_stats == stats
    assert_close_for(variant, fields(port.state), fields(state))
    assert calls == implied_calls(port)
    # the solve each variant is meant to reach
    schur = variant.startswith(("schur", "pinned_schur"))
    assert (getattr(port, "poisson_fdm", None) is not None) == (
        schur or variant == "cg_fdm")
    assert (getattr(port, "poisson_mg", None) is not None) == (
        variant in ("cg_mg", "pinned_cg_mg", "bn2"))
    if variant == "cg_mg":
        assert calls["poisson_apply_separable"] > 0


@pytest.mark.parametrize("variant", ["schur_pcg", "cg_mg", "pinned_schur"])
def test_float32_matches_jax(variant, tmp_path):
    jsolver = JaxSolver(config(tmp_path, "jax", variant, "float32"))
    state, stats = run_jax(jsolver, jsolver.state, NSTEPS)
    jsolver.close()
    port = TorchSolver(config(tmp_path, "port", variant, "float32"),
                       device="cpu")
    port_stats = run_port(port, NSTEPS)
    port.close()
    assert port.state["p"].dtype == torch.float32
    assert ([{k: s[k] for k in KEYS if k.endswith("_ok")} for s in port_stats]
            == [{k: s[k] for k in KEYS if k.endswith("_ok")} for s in stats])
    got, want = fields(port.state), fields(state)
    # dPhi's pressure is fixed only to the solve's tolerance
    dp_err = np.abs(got.pop("dp") - want.pop("dp")).max()
    assert dp_err <= 1e-4 * np.abs(want["p"]).max()
    assert_fields_close(got, want, 1e-4)


def test_state_carried_over_from_jax(tmp_path):
    jsolver = JaxSolver(config(tmp_path, "jax"))
    s10, _ = run_jax(jsolver, jsolver.state, 10)
    s15, stats15 = run_jax(jsolver, s10, NSTEPS)
    jsolver.close()
    port = TorchSolver(config(tmp_path, "port"), device="cpu")
    port.state = state_from_numpy(s10, "cpu", torch.float64)
    assert sorted(port.state) == sorted(s10)
    assert sorted(port.state["dPhi"]) == ["f", "p"]
    stats = run_port(port, NSTEPS)
    port.close()
    assert stats == stats15
    assert_fields_close(fields(port.state), fields(s15), 1e-9)


def test_sphere3d_matches_jax(tmp_path, monkeypatch):
    """The 3D coupled step: the Schur CG with K2a (the momentum refinement
    operator) and K3 (convection) in the path, against the JAX package
    with its Pallas kernels in interpret mode."""
    jsolver = JaxSolver(sphere_config(tmp_path, "jax"))
    assert jsolver.convect.__qualname__.startswith("make_pallas_convection")
    state, stats = run_jax(jsolver, jsolver.state, NSTEPS)
    jsolver.close()
    calls = count_calls(monkeypatch)
    port = TorchSolver(sphere_config(tmp_path, "port"), device="cpu")
    port_stats = run_port(port, NSTEPS)
    port.close()
    assert port_stats == stats
    got, want = fields(port.state), fields(state)
    # the last step's corrections carry the rounding of the 3D solve,
    # amplified by the conditioning of S (~800), at ~1e-11 absolute:
    # each is held to 1e-9 of the maximum of the field it corrects
    for key, of in (("dp", "p"), ("df", "f")):
        err = np.abs(got.pop(key) - want.pop(key)).max()
        assert err <= 1e-9 * np.abs(want[of]).max(), (key, err)
    assert_fields_close(got, want, 1e-9)
    hist = port.stats_history
    # make_fdm_solver applies A twice, then once per refinement pass
    assert calls == {"fused_sweep": 0, "pcr": 0, "poisson_apply_separable": 0,
                     "zblocked_helmholtz_apply": sum(
                         3 * (2 + h["v_iters"]) for h in hist),
                     "convection3d_apply": len(hist)}


def test_cli_logs_match(tmp_path, capsys):
    from petibm_tpu.cli.ibpm import main as jax_main
    from petibm_tpu_torch.cli.ibpm import main as port_main

    cfg = cylinder_config(tmp_path, "src", nt=12, nsave=5, nrestart=100)
    _write_case(str(tmp_path / "jax_case"), cfg)
    _write_case(str(tmp_path / "port_case"), cfg)
    assert jax_main(["-directory", str(tmp_path / "jax_case")]) == 0
    assert port_main(["-directory", str(tmp_path / "port_case"),
                      "-device", "cpu"]) == 0
    assert "[time step 12]" in capsys.readouterr().out
    for name in ("iterations-0.txt", "forces-0.txt"):
        want = np.loadtxt(tmp_path / "jax_case" / "output" / name)
        got = np.loadtxt(tmp_path / "port_case" / "output" / name)
        assert got.shape == want.shape
        if name.startswith("iterations"):
            # step, v and p iterations and residuals: no force column
            assert want.shape == (12, 5)
            np.testing.assert_array_equal(got[:, (0, 1, 3)],
                                          want[:, (0, 1, 3)])
            np.testing.assert_allclose(got[:, 2::2], want[:, 2::2],
                                       rtol=1e-3, atol=1e-12)
        else:
            assert want.shape == (12, 3)
            # the symmetric flow's lift is rounding noise (~1e-12) beside
            # the impulsive start's drag (~500): atol is 1e-12 of the
            # largest force
            np.testing.assert_allclose(
                got, want, rtol=1e-7, atol=1e-12 * np.abs(want[:, 1:]).max())


@pytest.mark.parametrize("params,item", [
    # in one process a two-device mesh is a configuration error (the
    # coupled IBPM's refusal under a process group:
    # tests/test_torch_parallel.py)
    ({"sharding": {"nDevices": 2}}, "nDevices=2"),
])
def test_unsupported_configs_raise(tmp_path, params, item):
    cfg = config(tmp_path, "port")
    cfg["parameters"].update(params)
    with pytest.raises(ValueError, match=item):
        TorchSolver(cfg, device="cpu")


@pytest.mark.parametrize("pinned", [False, True])
def test_chip_smoke_re550_config_is_the_example(tmp_path, pinned):
    """chip_smoke.py's dict of examples/ibpm/cylinder2dRe550[_GPU] (the
    card need not have pyyaml) holds the example's mesh, flow, time
    stepping, body and resolved solver settings."""
    from chip_smoke import RE550_DIR, re550_config
    from petibm_tpu_torch.config import load_config, solver_config

    got = re550_config(str(tmp_path / "smoke"), pinned)
    want = load_config(directory=RE550_DIR + ("_GPU" if pinned else ""))
    assert got["mesh"] == want["mesh"]
    assert got["flow"] == want["flow"]
    for key in ("dt", "nt", "convection", "diffusion"):
        assert got["parameters"][key] == want["parameters"][key], key
    assert ([os.path.basename(b["file"]) for b in got["bodies"]]
            == [b["file"] for b in want["bodies"]])
    for role in ("velocity", "poisson"):
        a, b = solver_config(got, role), solver_config(want, role)
        for key in ("type", "atol", "rtol", "max_it", "pc", "backend"):
            assert a[key] == b[key], (role, key)
