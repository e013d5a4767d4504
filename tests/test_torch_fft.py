"""The FDM's FFT path (``fdm.fft: true``, and the pinned solves' FFT
default): the port against the JAX package.

(a) ``FastDiagPoisson`` with ``use_fft`` on and off, on the grids of
    ``test_fdm.py``'s FFT tests (periodic uniform axes on both 2D axes,
    on one 2D axis, on two of three 3D axes): the same ``_fft_axes`` as
    JAX's, solutions to 1e-12 relative in float64 and to JAX's own
    3e-5 x scale in float32 (``test_fdm.py:74``); a periodic stretched
    axis keeps its dense transforms (``test_fdm.py:77``)
(b) ``FastDiagHelmholtz`` likewise (``test_fdm.py:85``)
(c) the 16^3 TGV (``test_torch_tgv3d.py``'s cut, ``fdm: {velocity:
    false, fft: true}``: the pressure solve by FFT on all three axes) and
    the periodic 2D Taylor-Green vortex (its example cut to 32^2 with
    ``fdm: {fft: true}``) through the solver, 5 steps: float64 stats
    equal and fields to 1e-9 of their maximum; float32 fields to 1e-4
    with equal ok flags (dP, fixed only to the solve's tolerance, to 1e-4
    of p's maximum)
(d) the options reach the solves: the velocity and pressure solves take
    the FFT only under ``fdm.fft``, the pinned pressure solve always, as
    in the JAX package
(e) ``fdm.fft: true`` in the decoupled and the coupled IBPM (y-periodic
    cylinder and channel), 5 steps in float64 against JAX: stats equal,
    fields to 1e-9
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petibm_tpu.linalg import fdm as jfdm
from petibm_tpu.solvers.navierstokes import NavierStokesSolver as JaxNS
from petibm_tpu_torch.convert import state_to_numpy
from petibm_tpu_torch.linalg import fdm as pfdm
from petibm_tpu_torch.solvers.navierstokes import NavierStokesSolver
from test_torch_decoupledibpm import assert_fields_close, host_stats
from test_torch_pinned import tgv2d
from test_torch_tgv3d import config as tgv3d_config

torch.set_num_threads(2)

NS_KEYS = ("v_iters", "v_ok", "p_iters", "p_ok")
DTYPES = {"float64": (jnp.float64, torch.float64),
          "float32": (jnp.float32, torch.float32)}


def _stretched(n, r=1.03, h0=0.02):
    return h0 * r ** np.arange(n)


# test_fdm.py::test_fft_path_matches_eigh's grids (fft axes 2, 1, 2) and
# test_fft_path_skips_stretched_periodic's (1)
POISSON = {
    "periodic_2d": ([np.full(32, 0.05), np.full(48, 0.03)], [True, True]),
    "x_periodic_2d": ([np.full(32, 0.05), _stretched(21)], [True, False]),
    "xy_periodic_3d": ([np.full(12, 0.1), np.full(16, 0.05), _stretched(9)],
                       [True, True, False]),
    "stretched_periodic_2d": ([_stretched(16), np.full(12, 0.1)],
                              [True, True]),
}


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def check_solution(got, want, dtype):
    if dtype == "float64":
        assert rel(got, want) <= 1e-12
    else:  # test_fdm.py:74's bound
        scale = max(1.0, float(np.abs(np.asarray(want)).max()))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=3e-5 * scale)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("use_fft", [True, False])
@pytest.mark.parametrize("name", sorted(POISSON))
def test_poisson_matches_jax(name, use_fft, dtype):
    dxp, periodic = POISSON[name]
    jdt, tdt = DTYPES[dtype]
    want_solver = jfdm.FastDiagPoisson(dxp, periodic, dtype=jdt, scale=0.01,
                                       use_fft=use_fft)
    solver = pfdm.FastDiagPoisson(dxp, periodic, dtype=tdt, device="cpu",
                                  scale=0.01, use_fft=use_fft)
    assert solver._fft_axes == want_solver._fft_axes
    assert solver._fft_sizes == want_solver._fft_sizes
    if use_fft:
        assert solver._fft_axes == {"periodic_2d": (0, 1),
                                    "x_periodic_2d": (1,),
                                    "xy_periodic_3d": (1, 2),
                                    "stretched_periodic_2d": (0,)}[name]
    assert tuple(solver.inv_lam.shape) == tuple(want_solver.inv_lam.shape)
    shape = tuple(reversed([len(d) for d in dxp]))
    r = np.random.default_rng(5).standard_normal(shape)
    got = solver.solve(torch.as_tensor(r, dtype=tdt))
    assert got.dtype == tdt and tuple(got.shape) == shape
    check_solution(got, want_solver.solve(jnp.asarray(r, jdt)), dtype)


@pytest.mark.parametrize("name", sorted(POISSON))
def test_fft_agrees_with_dense_transforms(name):
    """Within the port, as ``test_fdm.py:52`` holds JAX: the FFT path
    against the dense eigenvector transforms, float32, 3e-5 x scale."""
    dxp, periodic = POISSON[name]
    a, b = (pfdm.FastDiagPoisson(dxp, periodic, dtype=torch.float32,
                                 device="cpu", scale=0.01, use_fft=flag)
            for flag in (True, False))
    assert a._fft_axes and not b._fft_axes
    shape = tuple(reversed([len(d) for d in dxp]))
    r = torch.as_tensor(np.random.default_rng(5).standard_normal(shape),
                        dtype=torch.float32)
    check_solution(a.solve(r), b.solve(r), "float32")


def helmholtz_lines():
    """test_fdm.py::test_fft_helmholtz_matches_eigh's lines: x periodic
    uniform, y stretched with walls."""
    n, h = 24, 0.04
    dl = _stretched(17)
    mid = 0.5 * (dl[:-1] + dl[1:])
    return [
        {"dl": np.full(n, h), "dneg": np.full(n, h), "dpos": np.full(n, h),
         "a0": None, "periodic": True},
        {"dl": dl, "dneg": np.concatenate([[0.6 * dl[0]], mid]),
         "dpos": np.concatenate([mid, [0.6 * dl[-1]]]),
         "a0": (1.0, -1.0), "periodic": False},
    ]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("use_fft", [True, False])
def test_helmholtz_matches_jax(use_fft, dtype):
    lines = helmholtz_lines()
    jdt, tdt = DTYPES[dtype]
    want_solver = jfdm.FastDiagHelmholtz(lines, dt=0.01, cnu=0.02,
                                         dtype=jdt, use_fft=use_fft)
    solver = pfdm.FastDiagHelmholtz(lines, dt=0.01, cnu=0.02, dtype=tdt,
                                    device="cpu", use_fft=use_fft)
    assert solver._fft_axes == want_solver._fft_axes == ((1,) if use_fft
                                                         else ())
    r = np.random.default_rng(9).standard_normal((17, 24))
    check_solution(solver.solve(torch.as_tensor(r, dtype=tdt)),
                   want_solver.solve(jnp.asarray(r, jdt)), dtype)


def tgv3d(tmp_path, name, dtype):
    return tgv3d_config(tmp_path, name, dtype=dtype,
                        fdm={"velocity": False, "fft": True})


def tgv2d_fft(tmp_path, name, dtype):
    cfg = tgv2d(tmp_path, name, dtype)
    cfg["parameters"]["poissonSolver"]["type"] = "CPU"
    cfg["parameters"].update(nt=5, fdm={"fft": True})
    return cfg


CASES = {"tgv3d": tgv3d, "tgv2d": tgv2d_fft}


def fields(state):
    if isinstance(state["p"], torch.Tensor):
        state = state_to_numpy(state)
    state = jax.device_get(state)
    return dict(state["q"], p=state["p"], dP=state["dP"])


def run_jax(cfg):
    solver = JaxNS(cfg)
    fft = solver.poisson_fdm._fft_axes
    state, stats = solver.state, []
    for _ in range(cfg["parameters"]["nt"]):
        state, s = solver._step_fn(state)
        stats.append(host_stats(s, NS_KEYS))
    solver.close()
    return jax.device_get(state), stats, fft


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_solver_fft_matches_jax(case, dtype, tmp_path):
    make = CASES[case]
    state, stats, fft_axes = run_jax(make(tmp_path, "jax", dtype))
    port = NavierStokesSolver(make(tmp_path, "port", dtype), device="cpu")
    # every axis of these boxes is periodic and uniform
    assert port.poisson_fdm._fft_axes == fft_axes == tuple(
        range(port.mesh.dim))
    port.run()
    port.close()
    port_stats = [{k: h[k] for k in NS_KEYS} for h in port.stats_history]
    assert all(s["p_ok"] and s["v_ok"] for s in port_stats)
    if dtype == "float64":
        assert port_stats == stats
        assert_fields_close(fields(port.state), fields(state), 1e-9)
    else:
        assert ([{k: s[k] for k in s if k.endswith("_ok")}
                 for s in port_stats]
                == [{k: s[k] for k in s if k.endswith("_ok")}
                    for s in stats])
        got, want = fields(port.state), fields(state)
        dp_err = np.abs(got.pop("dP") - want.pop("dP")).max()
        assert dp_err <= 1e-4 * np.abs(want["p"]).max()
        assert_fields_close(got, want, 1e-4)


@pytest.mark.parametrize("fft", [False, True])
def test_fft_option_reaches_the_solves(fft, tmp_path, monkeypatch):
    """``fdm.fft`` sets the velocity Helmholtz and the pressure FDM
    solves' transforms (JAX ``navierstokes.py:319-323, 490-494``); the
    pinned pressure solve takes the FFT whatever it says (JAX ``:423``)."""
    from petibm_tpu_torch.solvers import navierstokes as ns

    helm = []

    class Recorded(pfdm.FastDiagHelmholtz):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            helm.append(self._fft_axes)

    monkeypatch.setattr(ns, "FastDiagHelmholtz", Recorded)
    cfg = tgv2d(tmp_path, "case", "float64")
    cfg["parameters"]["fdm"] = {"fft": fft}
    # the role's defaults: the FDM Helmholtz velocity solve
    cfg["parameters"]["velocitySolver"] = {"type": "CPU", "atol": 1e-8}
    pinned = NavierStokesSolver(cfg, device="cpu")
    assert pinned.is_ref_p and pinned._poisson_fdm_pinned._fft_axes == (0, 1)
    cfg["parameters"]["poissonSolver"]["type"] = "CPU"
    solver = NavierStokesSolver(cfg, device="cpu")
    want = (0, 1) if fft else ()
    assert solver.poisson_fdm._fft_axes == want
    assert helm == [want] * 4  # u and v of both solvers
    jsolver = JaxNS(cfg)
    assert jsolver.poisson_fdm._fft_axes == want
    jsolver.close()
    pinned.close()
    solver.close()


def test_chip_smoke_tgv2d_config_is_the_example(tmp_path):
    """chip_smoke.py's dict of examples/navierstokes/taylorgreenvortex2dRe100
    (phase 13 (c); the card need not have pyyaml) holds the example's flow,
    time step and resolved solver settings, on the example's box cut to
    32^2 cells."""
    from chip_smoke import tgv2d_config
    from petibm_tpu_torch.config import load_config, solver_config
    from test_torch_pinned import TGV2D_DIR

    got = tgv2d_config(str(tmp_path / "smoke"))
    want = load_config(directory=TGV2D_DIR)
    assert got["flow"] == want["flow"]
    assert got["parameters"]["dt"] == want["parameters"]["dt"]
    for key in ("convection", "diffusion"):
        assert got["parameters"][key] == want["parameters"][key], key
    for a, b in zip(got["mesh"], want["mesh"]):
        assert (a["direction"], a["start"]) == (b["direction"], b["start"])
        (sa,), (sb,) = a["subDomains"], b["subDomains"]
        assert (sa["end"], sa["stretchRatio"]) == (sb["end"],
                                                   sb["stretchRatio"])
        assert (sa["cells"], sb["cells"]) == (32, 256)
    for role in ("velocity", "poisson"):
        a, b = solver_config(got, role), solver_config(want, role)
        for key in ("type", "atol", "rtol", "max_it", "pc", "backend",
                    "pc_explicit"):
            assert a.get(key) == b.get(key), (role, key)


def _y_periodic(cfg):
    for bc in cfg["flow"]["boundaryConditions"]:
        if bc["location"] in ("yMinus", "yPlus"):
            bc["u"] = ["PERIODIC", 0.0]
            bc["v"] = ["PERIODIC", 0.0]
    return cfg


def decoupled_case(tmp_path, name):
    from __graft_entry__ import _cylinder_config

    d = tmp_path / name
    (d / "output").mkdir(parents=True)
    (d / "logs").mkdir()
    cfg = _y_periodic(_cylinder_config(32, str(d)))
    cfg["parameters"].update(dtype="float64", nt=5, fdm={"fft": True})
    return cfg


def coupled_case(tmp_path, name):
    from test_ibm import ib_config

    d = tmp_path / name
    d.mkdir()
    return _y_periodic(ib_config(d, n=30, nt=5, solver_extra={
        "dtype": "float64", "fdm": {"fft": True}}))


IBM_CASES = {"decoupled": (decoupled_case, "decoupledibpm",
                           "DecoupledIBPMSolver"),
             "coupled": (coupled_case, "ibpm", "IBPMSolver")}


@pytest.mark.parametrize("case", sorted(IBM_CASES))
def test_ibm_solvers_fft_match_jax(case, tmp_path):
    """``fdm.fft: true`` in the decoupled and the coupled IBPM (the 32^2
    cylinder and the 30^2 channel with periodic y walls: the FDM solves
    transform y by FFT): 5 steps in float64 against the JAX package,
    every stat equal, the fields to 1e-9 of their maximum."""
    import importlib

    from test_torch_decoupledibpm import host_stats

    make, module, name = IBM_CASES[case]
    jax_cls = getattr(importlib.import_module(
        f"petibm_tpu.solvers.{module}"), name)
    port_cls = getattr(importlib.import_module(
        f"petibm_tpu_torch.solvers.{module}"), name)
    jsolver = jax_cls(make(tmp_path, "jax"))
    assert jsolver.poisson_fdm._fft_axes == (0,)
    state, stats = jsolver.state, []
    for _ in range(5):
        state, s = jsolver._step_fn(state)
        stats.append(host_stats(s, NS_KEYS))
    jsolver.close()
    port = port_cls(make(tmp_path, "port"), device="cpu")
    assert port.poisson_fdm._fft_axes == (0,)
    for _ in range(5):
        port.advance()
    port.close()
    assert [{k: h[k] for k in NS_KEYS} for h in port.stats_history] == stats
    got, want = port.state, jax.device_get(state)
    for key in ("p", "f"):
        w = np.asarray(want[key])
        assert (np.abs(got[key].numpy() - w).max()
                <= 1e-9 * np.abs(w).max()), key
    for key, w in want["q"].items():
        w = np.asarray(w)
        assert (np.abs(got["q"][key].numpy() - w).max()
                <= 1e-9 * np.abs(w).max()), key
