"""E and H of the factor delta engine over each point's window
(``ibm/cuda_delta.py``, ``csrc/delta_ops.cu``).

On the CPU the wrappers run their plain twins.  The twins are held, in
float64, to 1e-12 of each output's maximum against the JAX package's
factor engine (dense contractions of whole-grid-line factor rows): in 2D
and 3D, with walls and with a periodic x (a window wrapping across it),
the Roma and the Peskin kernels, and points by a wall (clamped windows,
zero-weight slots); E, H into zero grids, and H added into an array and
scaled (the B_1 = dt I fold of the decoupled step).  ``DeltaOp.spread``'s
fold equals the unfolded ``into + scale * H f`` bit for bit, the twins
repeat their bits, the wrappers call them on CPU tensors (no launch
counted), vmapped calls (the coupled solver's Schur columns) keep the
dense contraction, and the K forms of the windows equal the windowed
engine's.

On a card (``cuda``; no JAX imported): each kernel equals its twin at
tolerance 0 at the sphere's (160x130x130, 1963 points) and the
cylinder's (450x450, 314 points) shapes in float32 and float64, H's bits
repeat run to run, and a chunk captured with the launch counters on the
card launches one E and two H a step of the decoupled step, with no new
device allocation (``cudaMalloc``) over its chunks:

    python -m pytest tests/test_torch_delta_kernels.py --noconftest -m cuda
"""

import types

import numpy as np
import pytest
import torch

import petibm_tpu_torch.ibm.interp as tinterp
import petibm_tpu_torch.mesh as tm
from petibm_tpu_torch.ibm import cuda_delta
from petibm_tpu_torch.types import Field

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
TOL = 1e-12
DT = 0.02


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side, imported here and not with the module: the
    card tests run where jax is not installed."""
    import jax.numpy as jnp

    import petibm_tpu.ibm.interp as jinterp
    import petibm_tpu.mesh as jm

    return types.SimpleNamespace(jnp=jnp, interp=jinterp, mesh=jm)


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-300))


def _mesh_config(ndim, periodic):
    axes = [{"direction": d, "start": -1.0, "subDomains": [
        {"end": -0.3, "cells": 6, "stretchRatio": 0.9},
        {"end": 0.3, "cells": 12, "stretchRatio": 1.0},
        {"end": 1.0, "cells": 6, "stretchRatio": 1.1}]}
        for d in ("x", "y", "z")[:ndim]]
    names = ("u", "v", "w")[:ndim]
    bcs = []
    for d in ("x", "y", "z")[:ndim]:
        bct = "PERIODIC" if (periodic and d == "x") else "DIRICHLET"
        for side in ("Minus", "Plus"):
            bcs.append({"location": d + side,
                        **{f: [bct, 0.0] for f in names}})
    return {"mesh": axes, "flow": {"nu": 0.01, "boundaryConditions": bcs}}


#: name -> (dim, periodic x, kernel, points by a wall)
CASES = {
    "2d_walls_roma": (2, False, "ROMA_ET_AL_1999", False),
    "2d_xperiodic_peskin": (2, True, "PESKIN_2002", False),
    "2d_wall_roma": (2, False, "ROMA_ET_AL_1999", True),
    "3d_walls_roma": (3, False, "ROMA_ET_AL_1999", False),
    "3d_xperiodic_peskin": (3, True, "PESKIN_2002", False),
    "3d_wall_peskin": (3, False, "PESKIN_2002", True),
}
NPTS = 23


def _points(ndim, periodic, wall, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-0.25, 0.25, size=(NPTS, ndim))
    if periodic:  # a window wrapping across the periodic x faces
        X[0, 0] = 0.97
    if wall:  # windows clamped at the walls: zero-weight slots
        X[::3, 0] = rng.uniform(-0.99, -0.9, size=X[::3].shape[0])
        X[1::3, ndim - 1] = rng.uniform(0.9, 0.99, size=X[1::3].shape[0])
    return X


def _case(name):
    ndim, periodic, kernel, wall = CASES[name]
    cfg = _mesh_config(ndim, periodic)
    mesh = tm.StaggeredMesh(cfg)
    X = _points(ndim, periodic, wall)
    op = tinterp.make_delta_op(mesh, kernel, n_pts=NPTS, **F64)
    win = op.windows(torch.as_tensor(X))
    rng = np.random.default_rng(6)
    q = {n: torch.as_tensor(rng.standard_normal(mesh.shape(Field(c))))
         for c, n in enumerate(tinterp.VEL_NAMES[:ndim])}
    f = torch.as_tensor(rng.standard_normal((NPTS, ndim)))
    return types.SimpleNamespace(ndim=ndim, kernel=kernel, cfg=cfg, X=X,
                                 mesh=mesh, op=op, win=win, q=q, f=f)


def _fields(case):
    return [case.q[n] for n in tinterp.VEL_NAMES[:case.ndim]]


def _zeros(case):
    return [torch.zeros_like(x) for x in _fields(case)]


@pytest.mark.parametrize("op", ["E", "H", "H_into_scaled"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_twin_matches_jax_factor_engine(name, op, jx):
    c = _case(name)
    jmesh = jx.mesh.StaggeredMesh(c.cfg)
    jd = jx.interp.make_delta_op(jmesh, c.kernel, jx.jnp.float64,
                                 n_pts=NPTS)
    jwin = jd.windows(jx.jnp.asarray(c.X))
    if op == "E":
        _close(cuda_delta.interpolate(_fields(c), c.win),
               jd.interpolate({k: jx.jnp.asarray(v.numpy())
                               for k, v in c.q.items()}, jwin))
        return
    want = jd.spread(jx.jnp.asarray(c.f.numpy()), jwin)
    base = _zeros(c) if op == "H" else [x.clone() for x in _fields(c)]
    scale = None if op == "H" else DT
    got = [x.clone() for x in base]
    cuda_delta.spread(c.f, c.win, got, scale)
    for k, g, b in zip(tinterp.VEL_NAMES, got, base):
        w = np.asarray(want[k])
        _close(g, b.numpy() + (w if scale is None else scale * w))


@pytest.mark.parametrize("name", sorted(CASES))
def test_fold_equals_unfolded_add(name):
    """``spread(into=u, scale=dt)`` (the step's u* + B_1 H df, in place)
    equals u + dt * spread(...) bit for bit, and ``into`` alone rhs1 + H
    f; the arrays given as ``into`` are the ones returned."""
    c = _case(name)
    plain = c.op.spread(c.f, c.win)
    for scale in (None, DT):
        into = {k: v.clone() for k, v in c.q.items()}
        got = c.op.spread(c.f, c.win, into=into, scale=scale)
        for k in c.q:
            want = c.q[k] + (plain[k] if scale is None else scale * plain[k])
            assert got[k] is into[k]
            assert torch.equal(got[k], want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_twins_repeat_their_bits(name):
    c = _case(name)
    a = cuda_delta.interpolate(_fields(c), c.win)
    b = cuda_delta.interpolate(_fields(c), c.win)
    assert torch.equal(a, b)
    ga, gb = _zeros(c), _zeros(c)
    cuda_delta.spread(c.f, c.win, ga, DT)
    cuda_delta.spread(c.f, c.win, gb, DT)
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))


def test_wrappers_call_the_twins_on_cpu(monkeypatch):
    """CPU tensors go to the twins, and no launch is counted."""
    c = _case("3d_walls_roma")
    calls = []
    for name in ("interpolate_ref", "spread_ref"):
        fn = getattr(cuda_delta, name)

        def record(*args, _fn=fn, _name=name):
            calls.append(_name)
            return _fn(*args)

        monkeypatch.setattr(cuda_delta, name, record)
    before = (cuda_delta.interpolate.launches, cuda_delta.spread.launches)
    c.op.interpolate(c.q, c.win)
    c.op.spread(c.f, c.win, into=dict(c.q), scale=DT)
    assert calls == ["interpolate_ref", "spread_ref"]
    assert (cuda_delta.interpolate.launches,
            cuda_delta.spread.launches) == before


def test_factor_values_of_repeated_gridlines():
    """A window clamped at a wall repeats gridline 0 with zero weights,
    and a periodic line shorter than K repeats gridlines with weights:
    each slot's factor value is the sum of the weights on its gridline,
    in slot order, and only its first slot is kept."""
    idx = torch.tensor([[0, 0, 0, 1, 2], [3, 0, 1, 2, 3]])
    w = torch.tensor([[0.0, 0.0, 0.5, 0.25, 0.125],
                      [0.5, 1.0, 2.0, 4.0, 8.0]], dtype=torch.float64)
    F, first = cuda_delta._factors(idx, w)
    assert torch.equal(F, torch.tensor([[0.5, 0.5, 0.5, 0.25, 0.125],
                                        [8.5, 1.0, 2.0, 4.0, 8.5]],
                                       dtype=torch.float64))
    assert first.tolist() == [[True, False, False, True, True],
                              [True, True, True, True, False]]


@pytest.mark.parametrize("name", ["2d_xperiodic_peskin", "3d_walls_roma"])
def test_vmapped_calls_keep_the_dense_contraction(name):
    """Under ``torch.func.vmap`` (the coupled solver's set-up-time Schur
    columns) E and H contract the factor rows: each batch entry equals the
    unbatched kernel path's to 1e-12."""
    c = _case(name)
    fs = torch.stack([c.f, 2.0 * c.f])
    h = torch.func.vmap(lambda f: c.op.spread(f, c.win))(fs)
    e = torch.func.vmap(lambda u: c.op.interpolate(u, c.win))(
        {k: torch.stack([v, -v]) for k, v in c.q.items()})
    for b, s in enumerate((1.0, 2.0)):
        want = c.op.spread(s * c.f, c.win)
        for k in want:
            _close(h[k][b], want[k])
    _close(e[0], c.op.interpolate(c.q, c.win))
    _close(e[1], -c.op.interpolate(c.q, c.win))


@pytest.mark.parametrize("name", ["2d_xperiodic_peskin", "3d_wall_peskin"])
def test_k_forms_equal_the_windowed_engine(name):
    """The factor engine's idx / wd / wv and box are the windowed engine's
    idx / sd / sv and box; ``whole`` spans every grid line."""
    c = _case(name)
    wop = tinterp.make_delta_op(c.mesh, c.kernel, engine="windowed", **F64)
    ww = wop.windows(torch.as_tensor(c.X))
    for comp in range(c.ndim):
        a, b = c.win[comp], ww[comp]
        assert a["idx"].dtype == torch.int32
        for d in range(c.ndim):
            assert torch.equal(a["idx"][d].long(), b["idx"][d])
            assert torch.equal(a["wd"][d], b["sd"][d])
            assert torch.equal(a["wv"][d], b["sv"][d])
        assert (a["lo"], a["hi"]) == (b["lo"], b["hi"])
    whole = c.op.windows(torch.as_tensor(c.X), whole=True)
    for comp, w in whole.items():
        assert w["lo"] == [0] * c.ndim and w["hi"] == c.op.n[comp]


# ----------------------------------------------------------------------
# on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def _to_cpu(win):
    return {c: {k: (v.cpu() if isinstance(v, torch.Tensor) else
                    [x.cpu() for x in v] if k in ("sd", "sv") else v)
                for k, v in w.items()} for c, w in win.items()}


DTYPES = [torch.float32, torch.float64]
#: the benchmark's configurations (``chip_smoke.DELTA_SHAPES``)
SHAPES = ["sphere3d_re300", "cylinder2d_re200"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", SHAPES)
def test_cuda_kernels_equal_twins(name, dtype):
    _card()
    import chip_smoke

    _, win, fields, f = chip_smoke._delta_case(name, dtype)
    cwin = _to_cpu(win)
    cfields = [x.cpu() for x in fields]
    e = cuda_delta.interpolate(fields, win)
    torch.cuda.synchronize()
    assert torch.equal(e.cpu(), cuda_delta.interpolate_ref(cfields, cwin))
    for scale in (None, 0.005):
        got = [x.clone() for x in fields]
        want = [x.clone() for x in cfields]
        cuda_delta.spread(f, win, got, scale)
        cuda_delta.spread_ref(f.cpu(), cwin, want, scale)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_spread_repeats_its_bits(dtype):
    _card()
    import chip_smoke

    _, win, fields, f = chip_smoke._delta_case("sphere3d_re300", dtype)
    runs = []
    for _ in range(3):
        got = [torch.zeros_like(x) for x in fields]
        cuda_delta.spread(f, win, got)
        runs.append(got)
    torch.cuda.synchronize()
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


@pytest.mark.cuda
@pytest.mark.parametrize("small", ["small_config", "small3d_config"])
def test_cuda_chunk_launches_one_e_and_two_h_a_step(small, tmp_path):
    """A chunk of 4 steps captured with the counters on the card: 4 E and
    8 H launches (the decoupled step's rhsForces, rhsVelocity and
    applyNoSlip), none counted on the host; no new device allocation
    (``cudaMalloc``) over three chunks."""
    _card()
    import chip_smoke
    from petibm_tpu_torch import _kernels
    from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver

    cfg = getattr(chip_smoke, small)(str(tmp_path / "run"), nt=4,
                                     nsave=1000, nrestart=1000,
                                     stepsPerDispatch=4)
    solver = DecoupledIBPMSolver(cfg, device="cuda")
    solver.run()                  # warm-up, capture, one chunk
    allocs = solver._device_allocs()
    solver.nt += 12
    solver.run()
    assert solver._device_allocs() == allocs
    _kernels.count_on_device("cuda")
    try:
        _kernels.reset_launch_counts()
        solver._chunk.capture()
        solver.nt += 4
        solver.run()
        counts = _kernels.device_launch_counts()
    finally:
        _kernels.count_on_device(None)
    solver._chunk.capture()
    assert solver.chunk_overflows == 0
    assert (counts["E"], counts["H"]) == (4, 8)
    assert all(n == 0 for n in _kernels.launch_counts().values())
    solver.close()
