"""The pinned pressure (``poissonSolver.type: GPU``, the reference's AmgX
backend: row and column 0 of the pressure operator the identity) on the
plain and decoupled solvers: the port against the JAX package.

- a 16^2 lid-driven cavity (``test_navierstokes.py``'s ``run_config``)
  with the pinned FDM solve (``PinnedSolve``) and with ``fdm: false``
  (CG + the V-cycle, its mean kept), 5 steps: float64 fields to 1e-9 of
  their maximum and every stat equal, float32 fields to 1e-4 with equal
  ok flags; the twin of ``test_pinned_pressure_backend_matches_mean_
  projection`` (the velocities of the pinned and the projected runs
  agree, the pressures up to a constant); K1 stays off the pinned
  operator;
- the 32^2 decoupled cylinder (``__graft_entry__._cylinder_config``) with
  the pinned pressure, 10 steps, to the same tolerances;
- the periodic 2D Taylor-Green vortex (its example cut to 32^2, 10 steps)
  with the pinned FDM solve and with ``fdm: false`` (the V-cycle's
  sweeps K6/K7), to the same tolerances: the pinned FDM solves of both
  packages transform the periodic uniform axes by FFT (their default,
  whatever ``fdm.fft`` says), and the port's ``_fft_axes`` are JAX's;
- the pinned operator and ``PinnedSolve`` on their own: the solve
  inverts the operator, on a tensor and on the ``p`` leaf of a dict.
"""

import os

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _cylinder_config
from petibm_tpu.solvers.decoupledibpm import DecoupledIBPMSolver as JaxIBPM
from petibm_tpu.solvers.navierstokes import NavierStokesSolver as JaxNS
from petibm_tpu_torch.convert import state_to_numpy
from petibm_tpu_torch.linalg.fdm import (FastDiagPoisson, PinnedSolve,
                                         pinned_operator)
from petibm_tpu_torch.linalg.mg import poisson_level0
from petibm_tpu_torch.operators.cuda_stencil import poisson_apply_separable_ref
from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver
from petibm_tpu_torch.solvers.navierstokes import NavierStokesSolver
from test_navierstokes import run_config
from test_torch_decoupledibpm import assert_fields_close, host_stats
from test_torch_mgcg import count_calls

torch.set_num_threads(2)

NS_KEYS = ("v_iters", "v_ok", "p_iters", "p_ok")
IBM_KEYS = NS_KEYS + ("f_iters", "f_ok")
PINNED = {"type": "GPU", "atol": 1e-10, "rtol": 0.0}


def cavity(tmp_path, name, dtype, fdm=True, backend="GPU"):
    d = tmp_path / name
    d.mkdir()
    cfg = run_config(d, nt=5)
    cfg["parameters"].update(dtype=dtype, poissonSolver=dict(
        PINNED, type=backend, atol=1e-10 if dtype == "float64" else 1e-6))
    if not fdm:
        cfg["parameters"]["fdm"] = False
    return cfg


def cylinder(tmp_path, name, dtype, fdm=True):
    d = tmp_path / name
    (d / "output").mkdir(parents=True)
    (d / "logs").mkdir()
    cfg = _cylinder_config(32, str(d))
    cfg["parameters"].update(dtype=dtype, nt=10)
    cfg["parameters"]["poissonSolver"] = dict(
        cfg["parameters"]["poissonSolver"], type="GPU")
    if not fdm:
        cfg["parameters"]["fdm"] = False
    return cfg


TGV2D_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "navierstokes",
    "taylorgreenvortex2dRe100")


def tgv2d(tmp_path, name, dtype, fdm=True):
    """examples/navierstokes/taylorgreenvortex2dRe100 (periodic on both
    axes; BiCGStab + Jacobi velocity, CG at atol 1e-6 pressure) cut to
    32^2 and 10 steps, with the pinned pressure."""
    from petibm_tpu_torch.config import load_config

    d = tmp_path / name
    cfg = load_config(directory=TGV2D_DIR)
    cfg["output"], cfg["logs"] = str(d / "output"), str(d / "logs")
    for axis in cfg["mesh"]:
        axis["subDomains"][0]["cells"] = 32
    cfg["parameters"].update(dtype=dtype, nt=10)
    cfg["parameters"]["poissonSolver"]["type"] = "GPU"
    if not fdm:
        cfg["parameters"]["fdm"] = False
    return cfg


def fields(state):
    if isinstance(state["p"], torch.Tensor):
        state = state_to_numpy({k: v for k, v in state.items()
                                if k in ("q", "p", "dP", "f", "df")})
    state = jax.device_get(state)
    out = dict(state["q"], p=state["p"], dP=state["dP"])
    out.update({k: state[k] for k in ("f", "df") if k in state})
    return out


def run_jax(cfg, cls, keys):
    """The JAX run's final state and stats, and the FFT axes of its pinned
    FDM solve (None without one)."""
    solver = cls(cfg)
    assert solver.is_ref_p
    pinned = getattr(solver, "_poisson_fdm_pinned", None)
    if getattr(solver, "poisson_mg", None) is not None:
        # the V-cycle as on the JAX package's chip (the Pallas sweep in
        # interpret mode), as test_torch_mgcg.py runs it
        solver.poisson_mg.use_pcr = True
        solver.poisson_mg._pallas_interpret = True
    state, stats = solver.state, []
    for _ in range(cfg["parameters"]["nt"]):
        state, s = solver._step_fn(state)
        stats.append(host_stats(s, keys))
    solver.close()
    return (jax.device_get(state), stats,
            None if pinned is None else pinned._fft_axes)


def run_port(cfg, cls, keys):
    solver = cls(cfg, device="cpu")
    solver.run()
    solver.close()
    return solver, [{k: h[k] for k in keys} for h in solver.stats_history]


CASES = {
    "cavity_fdm": (lambda t, n, dt: cavity(t, n, dt), JaxNS,
                   NavierStokesSolver, NS_KEYS),
    "cavity_mg": (lambda t, n, dt: cavity(t, n, dt, fdm=False), JaxNS,
                  NavierStokesSolver, NS_KEYS),
    "cylinder_fdm": (cylinder, JaxIBPM, DecoupledIBPMSolver, IBM_KEYS),
    "cylinder_mg": (lambda t, n, dt: cylinder(t, n, dt, fdm=False), JaxIBPM,
                    DecoupledIBPMSolver, IBM_KEYS),
    "tgv2d_fdm": (tgv2d, JaxNS, NavierStokesSolver, NS_KEYS),
    "tgv2d_mg": (lambda t, n, dt: tgv2d(t, n, dt, fdm=False), JaxNS,
                 NavierStokesSolver, NS_KEYS),
}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pinned_matches_jax(case, dtype, tmp_path, monkeypatch):
    make, jax_cls, port_cls, keys = CASES[case]
    state, stats, fft_axes = run_jax(make(tmp_path, "jax", dtype), jax_cls,
                                     keys)
    calls = count_calls(monkeypatch)
    port, port_stats = run_port(make(tmp_path, "port", dtype), port_cls,
                                keys)
    assert port.is_ref_p and getattr(port, "poisson_fdm", None) is None
    # K1 stays off the pinned operator and the V-cycle's level 0
    assert calls["poisson_apply_separable"] == 0
    if case.endswith("_fdm"):
        assert port._poisson_fdm_pinned._fft_axes == fft_axes
        # the FFT on both periodic uniform axes of the TGV, none elsewhere
        assert fft_axes == ((0, 1) if case.startswith("tgv2d") else ())
        assert getattr(port, "poisson_mg", None) is None
    else:
        assert port.poisson_mg._fused_apply0 is None
        vcycles = sum(1 + s["p_iters"] for s in port.stats_history)
        # K6/K7 on a grid with a periodic axis, K4/K5 otherwise
        sweep = "pcr" if any(port.mesh.periodic) else "fused_sweep"
        assert (calls[sweep]
                == port.poisson_mg.sweeps_per_vcycle() * vcycles)
    if dtype == "float64":
        assert port_stats == stats
        assert_fields_close(fields(port.state), fields(state), 1e-9)
    else:
        assert ([{k: s[k] for k in keys if k.endswith("_ok")}
                 for s in port_stats]
                == [{k: s[k] for k in keys if k.endswith("_ok")}
                    for s in stats])
        got, want = fields(port.state), fields(state)
        dp_err = np.abs(got.pop("dP") - want.pop("dP")).max()
        assert dp_err <= 1e-4 * np.abs(want["p"]).max()
        assert_fields_close(got, want, 1e-4)


def test_pinned_matches_mean_projection(tmp_path):
    """The pinned and the mean-projected cavity: velocities agree, the
    pressures up to a constant (the twin of
    test_navierstokes.py::test_pinned_pressure_backend_matches_mean_
    projection, with atol 1e-11 as there)."""
    runs = {}
    for backend in ("CPU", "GPU"):
        cfg = cavity(tmp_path, backend, "float64", backend=backend)
        cfg["parameters"]["poissonSolver"]["atol"] = 1e-11
        runs[backend], stats = run_port(cfg, NavierStokesSolver, NS_KEYS)
        assert stats[-1]["p_ok"] and stats[-1]["v_ok"]
    assert not runs["CPU"].is_ref_p and runs["GPU"].is_ref_p
    u1, u2 = (runs[b].state["q"]["u"].numpy() for b in ("CPU", "GPU"))
    np.testing.assert_allclose(u2, u1, atol=1e-7)
    p1, p2 = (runs[b].state["p"].numpy() for b in ("CPU", "GPU"))
    np.testing.assert_allclose(p2 - p2.mean(), p1 - p1.mean(), atol=1e-7)


class _DictSolve:
    """The FDM solve on the ``p`` leaf of a dict, ``f`` passed through."""

    def __init__(self, fdm):
        self.fdm = fdm

    def solve(self, r):
        return {"p": self.fdm.solve(r["p"]), "f": r["f"]}


@pytest.mark.parametrize("leaf", [None, "p"])
def test_pinned_solve_inverts_pinned_operator(leaf):
    """PinnedSolve of the FDM solve inverts the pinned -D B1 G on a
    stretched grid, to 1e-10 in float64; on a dict it leaves the other
    leaves alone."""
    rng = np.random.default_rng(7)
    dxp = [np.linspace(0.8, 1.4, 11), np.linspace(1.2, 0.7, 9)]
    kw = dict(dtype=torch.float64, device="cpu", scale=0.3)
    level = poisson_level0(dxp, [False, False], **kw)
    fdm = FastDiagPoisson(dxp, [False, False], **kw)

    def negA(p):
        return poisson_apply_separable_ref(p, level)

    b = torch.as_tensor(rng.standard_normal((9, 11)))
    if leaf is None:
        A, inner = pinned_operator(negA), fdm
    else:
        A = pinned_operator(lambda x: {"p": negA(x["p"]), "f": x["f"]}, "p")
        inner = _DictSolve(fdm)
        f = torch.as_tensor(rng.standard_normal(5))
        b = {"p": b, "f": f}
    x = PinnedSolve(inner, leaf).solve(b)
    got = A(x)
    if leaf is not None:
        assert torch.equal(x["f"], f) and torch.equal(got["f"], f)
        got, b = got["p"], b["p"]
    assert got[0, 0] == b[0, 0]
    np.testing.assert_allclose(got.numpy(), b.numpy(), atol=1e-10)
