"""The geometric multigrid port (``linalg/mg.py``) against the JAX
``PoissonMG`` on the same numpy inputs.

The JAX hierarchy runs as on its chip: ``use_pcr`` with its Pallas kernels
in interpret mode (the fused sweep on non-periodic levels, the PCR kernel
on periodic ones), the dispatch the port follows; the port runs the
kernels' wrappers, i.e. their plain twins on CPU tensors.

(a) every level's shape, c1d and w1d equal JAX's (float64, 1e-12) on odd,
    stretched and mixed-periodic 2D and 3D grids; ``poisson_level0`` is
    level 0
(b) ``apply_op`` per level, ``restrict`` and ``prolong`` (1e-12); ``smooth``,
    ``vcycle`` and the preconditioner (1e-9)
(c) MG-preconditioned CG: equal iteration counts and ok flags, solutions
    to 1e-9 (twins of test_mg.py and test_tridiag.py's MG-CG cases; the 3D
    case against the JAX package's CPU default, the LAPACK sweep)
(d) one V-cycle calls the sweep wrapper ``sweeps_per_vcycle()`` times
(e) on a card: a V-cycle with the kernels equals the twins' (f64 1e-12,
    f32 1e-5)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petibm_tpu.linalg.krylov import cg as jax_cg
from petibm_tpu.linalg.mg import PoissonMG as JaxMG
from petibm_tpu_torch.linalg import mg as mg_mod
from petibm_tpu_torch.linalg.krylov import cg
from petibm_tpu_torch.linalg.mg import PoissonMG, poisson_level0

torch.set_num_threads(2)

GRIDS = {
    "odd_2d": ([13, 10], [False, False]),
    "x_periodic_2d": ([16, 12], [True, False]),
    "y_periodic_2d": ([21, 16], [False, True]),
    "odd_3d": ([21, 18, 13], [False, False, False]),
    "mixed_3d": ([12, 10, 9], [False, True, False]),
    "periodic_3d": ([16, 16, 8], [True, True, True]),
}


def widths(ns, periodic):
    """Stretched widths on walled axes, uniform on periodic ones."""
    return [np.ones(n) / n if p else np.geomspace(1.0, 1.6, n) / n
            for n, p in zip(ns, periodic)]


def pair(name, dtype=np.float64, **kw):
    ns, periodic = GRIDS[name]
    jmg = JaxMG(widths(ns, periodic), periodic, dtype=jnp.dtype(dtype),
                scale=0.02, **kw)
    jmg.use_pcr = True
    jmg._pallas_interpret = True
    pmg = PoissonMG(widths(ns, periodic), periodic,
                    dtype={np.float32: torch.float32,
                           np.float64: torch.float64}[dtype],
                    device="cpu", scale=0.02, **kw)
    return jmg, pmg


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_levels_equal_jax(name):
    jmg, pmg = pair(name)
    assert len(pmg.levels) == len(jmg.levels) > 1
    for jl, pl in zip(jmg.levels, pmg.levels):
        assert tuple(pl.shape) == tuple(jl.shape)
        assert pl.periodic == jl.periodic
        for got, want in zip(pl.c1d + pl.w1d, jl.c1d + jl.w1d):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-12, atol=0)
        np.testing.assert_allclose(pl.diag_full().numpy(),
                                   np.asarray(jl.diag_full()), rtol=1e-12)
        for d in range(len(pl.c1d)):
            np.testing.assert_allclose(pl.coeff(d).numpy(),
                                       np.asarray(jl.coeff(d)), rtol=1e-12)
    ns, periodic = GRIDS[name]
    lvl0 = poisson_level0(widths(ns, periodic), periodic,
                          dtype=torch.float64, device="cpu", scale=0.02)
    assert lvl0.shape == pmg.levels[0].shape
    for got, want in zip(lvl0.c1d + lvl0.w1d,
                         pmg.levels[0].c1d + pmg.levels[0].w1d):
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_transfers_and_level_operators_equal_jax(name):
    jmg, pmg = pair(name)
    for lvl, level in enumerate(pmg.levels):
        phi = rand(level.shape, lvl)
        assert rel(pmg.apply_op(lvl, torch.as_tensor(phi)),
                   jmg.apply_op(lvl, jnp.asarray(phi))) <= 1e-12
        if lvl + 1 < len(pmg.levels):
            assert rel(pmg.restrict(lvl, torch.as_tensor(phi)),
                       jmg.restrict(lvl, jnp.asarray(phi))) <= 1e-12
        if lvl > 0:
            got = pmg.prolong(lvl, torch.as_tensor(phi))
            assert tuple(got.shape) == tuple(pmg.levels[lvl - 1].shape)
            assert rel(got, jmg.prolong(lvl, jnp.asarray(phi))) <= 1e-12


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_smooth_vcycle_and_preconditioner_equal_jax(name):
    jmg, pmg = pair(name, pre=1, post=1)
    for lvl in (0, len(pmg.levels) - 1):
        shape = pmg.levels[lvl].shape
        phi, rhs = rand(shape, 1), rand(shape, 2)
        assert rel(pmg.smooth(lvl, torch.as_tensor(phi), torch.as_tensor(rhs),
                              2),
                   jmg.smooth(lvl, jnp.asarray(phi), jnp.asarray(rhs), 2)) \
            <= 1e-9
    rhs = rand(pmg.levels[0].shape, 3)
    assert rel(pmg.vcycle(0, torch.as_tensor(rhs)),
               jmg.vcycle(0, jnp.asarray(rhs))) <= 1e-9
    assert rel(pmg.preconditioner()(torch.as_tensor(rhs)),
               jmg.preconditioner()(jnp.asarray(rhs))) <= 1e-9


MGCG = {
    # test_mg.py::test_mgcg_uniform (64^2 uniform walled)
    "uniform_64": ([np.full(64, 1 / 64)] * 2, [False, False]),
    # test_mg.py::test_mgcg_periodic (64^2, x periodic)
    "periodic_64": ([np.full(64, 1 / 64)] * 2, [True, False]),
    # test_mg.py::test_mgcg_odd_size_3d
    "odd_3d": ([np.full(21, 1 / 21), np.geomspace(1.0, 1.6, 18) / 18,
                np.full(13, 1 / 13)], [False, False, False]),
    # test_tridiag.py::test_mgcg_with_pallas_pcr_smoother (stretched)
    "stretched_48x40": ([np.geomspace(1.0, 3.0, 48),
                         np.geomspace(1.0, 2.0, 40)], [False, False]),
}


@pytest.mark.parametrize("name", sorted(MGCG))
def test_mgcg_iterations_equal_jax(name):
    dxp, periodic = MGCG[name]
    jmg = JaxMG(dxp, periodic, dtype=jnp.float64)
    # 2D: the JAX Pallas sweeps in interpret mode; 3D: its CPU default, the
    # unfused LAPACK sweep (the 3D interpret-mode kernels inside CG's
    # while_loop take minutes to compile; (b) holds the 3D dispatch)
    jmg.use_pcr = jmg._pallas_interpret = len(dxp) == 2
    pmg = PoissonMG(dxp, periodic, dtype=torch.float64, device="cpu")
    b = rand(pmg.levels[0].shape, 4)
    b -= b.mean()
    want = jax_cg(lambda p: jmg.apply_op(0, p), jnp.asarray(b),
                  jnp.zeros(b.shape), M=jmg.preconditioner(), atol=1e-8,
                  maxiter=100)
    bt = torch.as_tensor(b)
    got = cg(lambda p: pmg.apply_op(0, p), bt, torch.zeros_like(bt),
             M=pmg.preconditioner(), atol=1e-8, maxiter=100)
    assert got.converged and bool(want.converged)
    assert got.iters == int(want.iters) <= 30
    assert rel(got.x, want.x) <= 1e-9


def test_vcycle_sweep_count_and_sharding(monkeypatch):
    calls = {"fused_sweep": 0, "pcr": 0}
    for name in calls:
        real = getattr(mg_mod, name)

        def counted(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(mg_mod, name, counted)
    for name, key in (("odd_3d", "fused_sweep"), ("mixed_3d", "pcr"),
                      ("y_periodic_2d", "pcr")):
        _, pmg = pair(name, pre=1, post=2, coarse_sweeps=3)
        before = dict(calls)
        pmg.vcycle(0, torch.as_tensor(rand(pmg.levels[0].shape)))
        nlev, dim = len(pmg.levels), pmg.dim
        assert pmg.sweeps_per_vcycle() == dim * ((nlev - 1) * 3 + 3)
        other = "pcr" if key == "fused_sweep" else "fused_sweep"
        assert calls[key] - before[key] == pmg.sweeps_per_vcycle()
        assert calls[other] == before[other]
    # undecomposed, ``cycle`` is the V-cycle from level 0 and no level
    # keeps blocks (the decomposed hierarchy: test_torch_parallel_mg.py)
    r = torch.as_tensor(rand(pmg.levels[0].shape, 1))
    assert pmg.part is None and pmg.blocks == []
    assert torch.equal(pmg.cycle(r), pmg.vcycle(0, r))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["odd_3d", "mixed_3d", "y_periodic_2d"])
def test_vcycle_kernels_match_twins_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ns, periodic = GRIDS[name]
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        rhs = torch.as_tensor(rand(tuple(reversed(ns))), dtype=dtype,
                              device="cuda")
        out = {}
        for kernels in (True, False):
            pmg = PoissonMG(widths(ns, periodic), periodic, dtype=dtype,
                            device="cuda", scale=0.02, kernels=kernels)
            out[kernels] = pmg.preconditioner()(rhs).cpu()
        assert rel(out[True], out[False]) <= tol
