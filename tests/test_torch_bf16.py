"""The bfloat16 V-cycle (``mg: {dtype: bfloat16}``): its kernels' twins
and the V-cycle against the JAX package, and the mixed-precision
preconditioner through the solvers.

(a) ``sweep_aux`` in bfloat16 equals JAX's ``sweep_aux(level, d,
    jnp.bfloat16)`` bit for bit, every level and direction, 2D and 3D
(b) each kernel's plain twin on bfloat16 tensors against its Pallas
    kernel in interpret mode, bit for bit: K1 (2D and 3D), K4
    (``fused_sweep``), K6 (``pcr_pallas``) and K7 (``pcr_pallas_blocked``,
    the same body a block); K5 (``fused_sweep_blocked``) adds the block
    axis's coupling to the right side in a pass of its own (b1 = rhs +
    coupling, then b1 / area in the kernel, where the twin forms rhs /
    area + w * coupling / w_e): each of those bfloat16 roundings moves the
    right side by up to half a unit of 2^-8, and the line solve carries
    that to x, so K5 is held to two units of 2^-8 (2^-7) of the largest
    value (measured: 0.39-0.72 of it on the three directions) and to more
    than half of its values equal (77-92% measured)
(c) ``PoissonMG(dtype=torch.bfloat16)``: its levels equal JAX's, and a
    V-cycle equals JAX's bit for bit on walled, mixed and periodic 2D and
    3D grids (the JAX V-cycle with its fused sweep in interpret mode on a
    walled grid, its PCR in jnp where an axis is periodic)
(d) the solvers with ``fdm: false`` and ``mg: {dtype: bfloat16}`` in
    float64 (the V-cycle's input rounded from float64 to bfloat16, so
    both packages feed it the same bits): the 16^2 cavity, the 32^2
    cylinder, the 16^3 TGV (K6/K7 on every level) and the coupled IBPM's
    30^2 channel, 5 steps each, against the JAX package: every stat equal
    each step (p_iters and the ok flags included), the fields to 1e-9 of
    their maximum; the wrappers called as the stats imply, bfloat16 calls
    counted like any other (K1 at the bfloat16 level-0 residual, none on
    a periodic grid or in the coupled solve, as in the JAX package)
(e) what does not take bfloat16 refuses it: K2 and K3, and ``mg.dtype``
    float16
(f) on a card: each bfloat16 kernel against its twin at tolerance 0, on
    every path of its plan.  The JAX side is imported inside the tests
    that use it, so these also run where jax is not installed:

    python -m pytest tests/test_torch_bf16.py --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

from petibm_tpu_torch.linalg import cuda_pcr, cuda_sweep
from petibm_tpu_torch.linalg.mg import PoissonMG, poisson_level0
from petibm_tpu_torch.operators import cuda_stencil as cs

torch.set_num_threads(2)

BF16 = torch.bfloat16
#: the unit roundoff of bfloat16 (8 significant bits)
UNIT = 2.0 ** -8


def widths(ns, periodic=None):
    """Stretched widths on walled axes, uniform on periodic ones."""
    periodic = periodic or [False] * len(ns)
    return [np.ones(n) / n if p else np.geomspace(1.0, 1.6, n) / n
            for n, p in zip(ns, periodic)]


def rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


def to_bf16(a):
    return torch.as_tensor(np.asarray(a, np.float64)).to(BF16)


def bits(t):
    """The bfloat16 bit patterns of a tensor or a JAX array."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy()
    return np.asarray(t).view(np.int16)


def assert_bits_equal(got, want):
    g, w = bits(got), bits(want)
    assert g.shape == w.shape
    assert (g == w).all(), f"{(g != w).sum()} of {g.size} values differ"


def pair(ns, periodic=None, **kw):
    import jax.numpy as jnp
    from petibm_tpu.linalg.mg import PoissonMG as JaxMG

    periodic = periodic or [False] * len(ns)
    jmg = JaxMG(widths(ns, periodic), periodic, dtype=jnp.bfloat16,
                scale=0.02, **kw)
    # walled grids: the fused Pallas sweep in interpret mode, as on the
    # JAX package's chip; a grid with a periodic axis: its CPU path, the
    # same PCR as pcr_pallas in jnp (test_k6/k7 hold the two equal), whose
    # interpret-mode kernels take minutes to compile in 3D
    jmg.use_pcr = jmg._pallas_interpret = not any(periodic)
    pmg = PoissonMG(widths(ns, periodic), periodic, dtype=BF16,
                    device="cpu", scale=0.02, **kw)
    return jmg, pmg


GRIDS = [[40, 24], [16, 12, 24]]


@pytest.mark.parametrize("ns", GRIDS)
def test_sweep_aux_bits_equal_jax(ns):
    import jax.numpy as jnp
    from petibm_tpu.linalg import pallas_sweep as jsw

    jmg, pmg = pair(ns)
    assert len(jmg.levels) == len(pmg.levels)
    for jl, pl in zip(jmg.levels, pmg.levels):
        for d in range(len(ns)):
            want = jsw.sweep_aux(jl, d, jnp.bfloat16)
            got = cuda_sweep.sweep_aux(pl, d, BF16)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.dtype == BF16 and g.is_contiguous()
                assert tuple(g.shape) == w.shape
                assert_bits_equal(g, w)


@pytest.mark.parametrize("ns", GRIDS)
def test_k1_twin_bits_equal_pallas(ns):
    import jax.numpy as jnp
    import petibm_tpu.operators.pallas_stencil as ps

    jmg, _ = pair(ns)
    level = poisson_level0(widths(ns), [False] * len(ns), dtype=BF16,
                           device="cpu", scale=0.02)
    phi = rand(level.shape)
    want = ps.poisson_apply_separable(jnp.asarray(phi, jnp.bfloat16),
                                      ps.separable_aux(jmg.levels[0]),
                                      interpret=True)
    got = cs.poisson_apply_separable(to_bf16(phi), level)
    assert got.dtype == BF16
    assert_bits_equal(got, want)


@pytest.mark.parametrize("ns", GRIDS)
def test_k4_twin_bits_equal_pallas(ns):
    import jax.numpy as jnp
    from petibm_tpu.linalg import pallas_sweep as jsw

    jmg, pmg = pair(ns)
    phi, rhs = rand(pmg.levels[0].shape, 1), rand(pmg.levels[0].shape, 2)
    for d in range(len(ns)):
        axis = len(ns) - 1 - d
        want = jsw.fused_sweep(jnp.asarray(phi, jnp.bfloat16),
                               jnp.asarray(rhs, jnp.bfloat16),
                               jsw.sweep_aux(jmg.levels[0], d, jnp.bfloat16),
                               line_axis=axis, omega=1.0, interpret=True)
        got = cuda_sweep.fused_sweep(to_bf16(phi), to_bf16(rhs),
                                     pmg._aux(0, d), axis, 1.0)
        assert_bits_equal(got, want)


def test_k5_twin_matches_pallas_blocked():
    """fused_sweep_blocked with 5-wide blocks (partial edge blocks), its
    right side b1 = rhs + the block axis's coupling formed in bfloat16
    first: two units of 2^-8 (the module docstring's reason)."""
    import jax.numpy as jnp
    from petibm_tpu.linalg import pallas_sweep as jsw

    ns = GRIDS[1]
    jmg, pmg = pair(ns)
    phi, rhs = rand(pmg.levels[0].shape, 1), rand(pmg.levels[0].shape, 2)
    for d in range(3):
        axis = 2 - d
        block_axis = 0 if axis != 0 else 1
        jphi = jnp.asarray(phi, jnp.bfloat16)
        b1 = (jnp.asarray(rhs, jnp.bfloat16)
              + jmg._coupling(0, jphi, 2 - block_axis))
        want = jsw.fused_sweep_blocked(
            jphi, b1, jsw.sweep_aux(jmg.levels[0], d, jnp.bfloat16),
            line_axis=axis, block_axis=block_axis, bs=5, omega=1.0,
            interpret=True)
        got = cuda_sweep.fused_sweep(to_bf16(phi), to_bf16(rhs),
                                     pmg._aux(0, d), axis, 1.0)
        g = got.to(torch.float64).numpy()
        w = np.asarray(want, np.float64)
        assert np.abs(g - w).max() <= 2 * UNIT * np.abs(w).max(), d
        assert (bits(got) == bits(want)).mean() > 0.5, d


def pcr_system(shape, axis, seed):
    from test_torch_tridiag import random_system

    return [to_bf16(v) for v in random_system(np.random.default_rng(seed),
                                              shape, axis)[:4]]


@pytest.mark.parametrize("axis", [0, 1])
def test_k6_twin_bits_equal_pallas_2d(axis):
    import jax.numpy as jnp
    from petibm_tpu.linalg.pallas_pcr import pcr_pallas

    shape = (37, 41) if axis == 0 else (41, 37)
    args = pcr_system(shape, axis, 3)
    want = pcr_pallas(*(jnp.asarray(v.float().numpy(), jnp.bfloat16)
                        for v in args), axis=axis, interpret=True)
    assert_bits_equal(cuda_pcr.pcr(*args, axis=axis), want)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_k7_twin_bits_equal_pallas_blocked_3d(axis):
    import jax.numpy as jnp
    from petibm_tpu.linalg.pallas_pcr import pcr_pallas_blocked

    shape = (12, 16, 16)
    args = pcr_system(shape, axis, 5)
    block_axis = 1 if axis != 1 else 0
    want = pcr_pallas_blocked(*(jnp.asarray(v.float().numpy(), jnp.bfloat16)
                                for v in args), axis=axis,
                              block_axis=block_axis, bs=4, interpret=True)
    assert_bits_equal(cuda_pcr.pcr(*args, axis=axis), want)


VCYCLE_GRIDS = {
    "walled_2d": ([40, 24], [False, False]),
    "y_periodic_2d": ([21, 16], [False, True]),
    "mixed_3d": ([12, 10, 9], [False, True, False]),
    "periodic_3d": ([16, 16, 8], [True, True, True]),
}


@pytest.mark.parametrize("name", sorted(VCYCLE_GRIDS))
def test_vcycle_bits_equal_jax(name):
    import jax
    import jax.numpy as jnp

    ns, periodic = VCYCLE_GRIDS[name]
    jmg, pmg = pair(ns, periodic, pre=1, post=1)
    for jl, pl in zip(jmg.levels, pmg.levels):
        assert tuple(pl.shape) == tuple(jl.shape)
        for got, want in zip(pl.c1d + pl.w1d, jl.c1d + jl.w1d):
            assert got.dtype == BF16
            assert_bits_equal(got, want)
    rhs = rand(pmg.levels[0].shape, 3)
    # jitted where no interpret-mode kernel is in it (compiled in seconds)
    vcycle = jmg.vcycle if jmg.use_pcr else jax.jit(jmg.vcycle,
                                                     static_argnums=0)
    want = vcycle(0, jnp.asarray(rhs, jnp.bfloat16))
    got = pmg.vcycle(0, to_bf16(rhs))
    assert got.dtype == BF16
    assert_bits_equal(got, want)


# ---------------------------------------------------------------------
# (d) the solvers

def cavity(tmp_path, name):
    from test_navierstokes import run_config

    d = tmp_path / name
    d.mkdir()
    return run_config(d, nt=5)


def cylinder(tmp_path, name):
    from test_torch_mgcg import cylinder as mgcg_cylinder

    return mgcg_cylinder(tmp_path, name, "float64")


def tgv(tmp_path, name):
    from test_torch_tgv3d import config

    return config(tmp_path, name, fdm=False)


def coupled(tmp_path, name):
    from test_ibm import ib_config

    d = tmp_path / name
    d.mkdir()
    return ib_config(d, n=30, nt=5)


SOLVERS = {
    # name: (config, JAX solver class, port solver class (module, name))
    "cavity": (cavity, ("navierstokes", "NavierStokesSolver")),
    "cylinder": (cylinder, ("decoupledibpm", "DecoupledIBPMSolver")),
    "tgv": (tgv, ("navierstokes", "NavierStokesSolver")),
    "coupled": (coupled, ("ibpm", "IBPMSolver")),
}
NS_KEYS = ("v_iters", "v_ok", "p_iters", "p_ok")


def mixed(cfg):
    cfg["parameters"].update(dtype="float64", fdm=False,
                             mg={"dtype": "bfloat16"}, nt=5)
    return cfg


def classes(case):
    import importlib

    module, name = SOLVERS[case][1]
    jax_cls = getattr(importlib.import_module(
        f"petibm_tpu.solvers.{module}"), name)
    port_cls = getattr(importlib.import_module(
        f"petibm_tpu_torch.solvers.{module}"), name)
    return jax_cls, port_cls


def compared(state):
    import jax
    from petibm_tpu_torch.convert import state_to_numpy

    if isinstance(state["p"], torch.Tensor):
        state = state_to_numpy({k: v for k, v in state.items()
                                if k in ("q", "p", "dP", "f", "dPhi")})
    state = jax.device_get(state)
    out = dict(state["q"], p=state["p"])
    out.update({k: state[k] for k in ("f", "dP") if k in state})
    if "dPhi" in state:
        out.update(dp=state["dPhi"]["p"], df=state["dPhi"]["f"])
    return out


def implied_calls(case, solver) -> dict:
    """The wrapper calls the stats imply: the bfloat16 V-cycle's sweeps,
    K1 at its level-0 residual on a walled grid of the uncoupled solvers,
    and the float64 CG operator (K1 or K2b) once per CG iteration and
    once for the first residual; K2a and K3 in 3D."""
    hist = solver.stats_history
    lp = solver.poisson_mg_lp
    vcycles = sum(1 + h["p_iters"] for h in hist)
    periodic = any(solver.mesh.periodic)
    sweeps = lp.sweeps_per_vcycle() * vcycles
    want = {"fused_sweep": 0 if periodic else sweeps,
            "pcr": sweeps if periodic else 0,
            "poisson_apply_separable": 0, "zblocked_helmholtz_apply": 0,
            "convection3d_apply": 0}
    if case in ("cavity", "cylinder"):
        want["poisson_apply_separable"] = 2 * vcycles
    if case == "tgv":
        want["zblocked_helmholtz_apply"] = (
            sum(3 * (1 + 2 * h["v_iters"]) for h in hist) + vcycles)
        want["convection3d_apply"] = len(hist)
    return want


@pytest.mark.parametrize("case", sorted(SOLVERS))
def test_solver_bf16_vcycle_matches_jax(case, tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp
    from test_torch_mgcg import count_calls

    make = SOLVERS[case][0]
    jax_cls, port_cls = classes(case)
    jsolver = jax_cls(mixed(make(tmp_path, "jax")))
    lp = jsolver.poisson_mg_lp
    assert lp.dtype == jnp.bfloat16
    # 2D: the JAX V-cycle as on its chip (the Pallas sweep in interpret
    # mode), as test_torch_mgcg.py runs it; 3D periodic: its CPU path, the
    # same PCR in jnp
    lp.use_pcr = lp._pallas_interpret = jsolver.mesh.dim == 2
    state, stats = jsolver.state, []
    for _ in range(5):
        state, s = jsolver._step_fn(state)
        s = jax.device_get(s)
        stats.append({k: (int(s[k]) if k.endswith("_iters") else bool(s[k]))
                      for k in NS_KEYS})
    jsolver.close()
    calls = count_calls(monkeypatch)
    port = port_cls(mixed(make(tmp_path, "port")), device="cpu")
    assert port.poisson_mg_lp.dtype == BF16
    assert port.poisson_mg.dtype == torch.float64
    # K1 at the bfloat16 level-0 residual where JAX has its Pallas K1
    assert ((port.poisson_mg_lp._fused_apply0 is not None)
            == (case in ("cavity", "cylinder")))
    for _ in range(5):
        port.advance()
    port.close()
    port_stats = [{k: h[k] for k in NS_KEYS} for h in port.stats_history]
    assert all(s["p_ok"] and s["p_iters"] > 0 for s in stats)
    bound = ROUNDING.get(case)
    if bound is None:
        assert port_stats == stats
    else:
        assert_within_rounding(port_stats, stats, bound)
    assert_fields_within(compared(port.state), compared(jax.device_get(state)),
                         bound)
    assert calls == implied_calls(case, port)


#: The coupled IBPM's outer CG with the bfloat16 V-cycle is sensitive to
#: rounding in its float64 data: the JAX package against itself, its
#: initial velocity perturbed by one ulp (seeds 0-3), keeps the iteration
#: counts of steps 1-3, takes 35 in place of 42 at step 4 (seed 3) and
#: 29-32 in place of 31 at step 5, and moves u, v by up to 1.9e-6, p, f by
#: up to 3.3e-5 of their maxima and the increments dp, df by up to 8.2e-4
#: of theirs (``test_coupled_bf16_rounding_sensitivity`` holds seed 3).
#: The port and the JAX package part the same way: their float64 means
#: (summed in other orders) differ at 1e-21, which flips one bfloat16 value
#: of a V-cycle's input at step 4.  So: every stat equal for 3 steps, the
#: ok flags for all, the iteration counts after that within 7 of JAX's, u,
#: v, p, f to 1e-4 and dp, df to 2e-3 (about 3 times the spread measured).
ROUNDING = {"coupled": {"steps_equal": 3, "iters": 7, "fields": 1e-4,
                        "increments": 2e-3}}


def assert_within_rounding(got, want, bound):
    n = bound["steps_equal"]
    assert got[:n] == want[:n]
    assert [s["p_ok"] and s["v_ok"] for s in got] == [
        s["p_ok"] and s["v_ok"] for s in want]
    for g, w in zip(got[n:], want[n:]):
        assert abs(g["p_iters"] - w["p_iters"]) <= bound["iters"], (g, w)


def assert_fields_within(got, want, bound=None):
    """Each field to 1e-9 of its maximum, or to ``bound``'s: the
    increments dp, df to ``increments``, the others to ``fields``."""
    for key, w in want.items():
        w = np.asarray(w)
        tol = (1e-9 if bound is None else
               bound["increments"] if key in ("dp", "df") else
               bound["fields"])
        err = np.abs(np.asarray(got[key]) - w).max()
        assert err <= tol * max(np.abs(w).max(), 1e-300), (key, err)


def test_coupled_bf16_rounding_sensitivity(tmp_path):
    """The ground of ROUNDING["coupled"]: the JAX package against itself,
    the initial velocity perturbed by one ulp (seed 3), keeps the stats of
    three steps, changes the iteration count of the fourth, and stays
    inside the bounds."""
    import jax
    import jax.numpy as jnp

    jax_cls, _ = classes("coupled")
    jsolver = jax_cls(mixed(coupled(tmp_path, "jax")))
    lp = jsolver.poisson_mg_lp
    lp.use_pcr = lp._pallas_interpret = True
    start = jax.device_get(jsolver.state)

    def run(state):
        stats = []
        for _ in range(5):
            state, s = jsolver._step_fn(state)
            s = jax.device_get(s)
            stats.append({k: (int(s[k]) if k.endswith("_iters")
                              else bool(s[k])) for k in NS_KEYS})
        return jax.device_get(state), stats

    base, stats = run(start)
    rng = np.random.default_rng(3)
    eps = np.finfo(np.float64).eps
    q = {k: jnp.asarray(np.asarray(v) * (1 + eps * rng.choice(
        [-1, 1], size=np.shape(v)))) for k, v in start["q"].items()}
    pert, pstats = run(dict(start, q=q))
    jsolver.close()
    bound = ROUNDING["coupled"]
    assert pstats[3]["p_iters"] != stats[3]["p_iters"]
    assert_within_rounding(pstats, stats, bound)
    assert_fields_within(compared(pert), compared(base), bound)


# ---------------------------------------------------------------------
# (e) refusals

def test_k2_k3_refuse_bf16():
    f = torch.zeros(4, 5, 6, dtype=BF16)
    vecs = {k: torch.zeros(f.shape["zyx".index(k[-1])], dtype=BF16)
            for k in cs.ZBLOCKED_KEYS}
    with pytest.raises(TypeError, match="K2 takes float32 or float64, got"):
        cs.zblocked_helmholtz_apply(f, vecs, (True, True, True))
    with pytest.raises(TypeError, match="K3 takes float32 or float64, got"):
        cs.convection3d_apply((f, f, f), None)


def test_mg_dtype_float16_refused(tmp_path):
    from petibm_tpu_torch.solvers.navierstokes import NavierStokesSolver

    cfg = mixed(cavity(tmp_path, "case"))
    cfg["parameters"]["mg"] = {"dtype": "float16"}
    with pytest.raises(NotImplementedError, match="mg.dtype float16"):
        NavierStokesSolver(cfg, device="cpu")


# ---------------------------------------------------------------------
# (f) on a card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _equal_on_card(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == BF16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("ns", [[40, 24], [450, 450], [16, 12, 24],
                                [160, 130, 130]])
def test_k1_bf16_equals_twin_on_card(ns):
    dev = _card()
    level = poisson_level0(widths(ns), [False] * len(ns), dtype=BF16,
                           device=dev, scale=0.02)
    phi = to_bf16(rand(level.shape)).to(dev)
    before = cs.poisson_apply_separable.launches
    got = cs.poisson_apply_separable(phi, level)
    assert cs.poisson_apply_separable.launches == before + 1
    _equal_on_card(got, cs.poisson_apply_separable_ref(phi, level))


@pytest.mark.cuda
@pytest.mark.parametrize("ns", [[450, 450], [225, 225], [33, 17],
                                [160, 130, 130], [80, 65, 65],
                                [13, 10, 24]])
def test_k4_k5_bf16_equals_twin_on_card(ns):
    """Every direction, on the plan's path and on every path and row
    count the shape admits."""
    dev = _card()
    mg = PoissonMG(widths(ns), [False] * len(ns), dtype=BF16, device=dev,
                   scale=0.02)
    shape = tuple(mg.levels[0].shape)
    phi, rhs = (to_bf16(rand(shape, s)).to(dev) for s in (1, 2))
    shape3 = (1,) * (3 - len(ns)) + shape
    for d in range(len(ns)):
        axis = len(ns) - 1 - d
        aux = mg._aux(0, d)
        want = cuda_sweep.fused_sweep_ref(phi, rhs, aux, axis, 1.0)
        _equal_on_card(cuda_sweep.fused_sweep(phi, rhs, aux, axis, 1.0),
                       want)
        axis3 = axis + 3 - len(ns)
        plans = [cuda_pcr.block_plan(shape3, axis3)]
        if shape[axis] <= cuda_sweep.WARP_LINE:
            path = "warp_rows" if axis3 == 2 else "warp_tiles"
            widths_ = ((cuda_sweep.ROWS_WARPS,) if axis3 == 2
                       else (cuda_sweep.TILE_LINES,
                             cuda_sweep.WIDE_TILE_LINES))
            plans += [cuda_pcr.Plan(path, r, w)
                      for r in cuda_sweep.WARP_ROWS if 32 * r >= shape[axis]
                      for w in widths_]
        for plan in plans:
            _equal_on_card(cuda_sweep.launch(phi, rhs, aux, axis, 1.0, plan),
                           want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 256, 256), (64, 64, 64),
                                   (8, 300, 40), (1, 37, 41)])
def test_k6_k7_bf16_equals_twin_on_card(shape):
    dev = _card()
    for axis in range(3):
        args = [t.to(dev) for t in pcr_system(shape, axis, 7)]
        want = cuda_pcr.pcr_ref(*args, axis)
        _equal_on_card(cuda_pcr.pcr(*args, axis=axis), want)
        n = shape[axis]
        plans = [cuda_pcr.block_plan(shape, axis)]
        if n <= cuda_pcr.WARP_LINE:
            path = "warp_rows" if axis == 2 else "warp_tiles"
            lines = (cuda_pcr.ROWS_WARPS if axis == 2
                     else cuda_pcr.TILE_LINES)
            plans += [cuda_pcr.Plan(path, r, lines) for r in (1, 2, 4, 8)
                      if 32 * r >= n]
        for plan in plans:
            _equal_on_card(cuda_pcr.launch(*args, axis, plan), want)
