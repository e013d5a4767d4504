"""K1, the separable pressure Poisson apply, on 2D [48, 32] and 3D
[12, 10, 32] stretched grids: the port's level-0 factors against
PoissonMG's finest level, the plain twin against the Pallas kernel in
interpret mode and the JAX -A_poisson closure (float64, 1e-12), the
wrapper's CPU dispatch, and the CUDA kernel against its twin on a card.

The JAX side is imported inside the tests that use it, so the card-only
tests also run where jax is not installed:

    python -m pytest tests/test_torch_poisson_kernel.py --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

from petibm_tpu_torch.linalg.mg import poisson_level0
from petibm_tpu_torch.operators import cuda_stencil as cs

torch.set_num_threads(2)

SHAPES = {"2d": [48, 32], "3d": [12, 10, 32]}


def _widths(ns):
    return [np.geomspace(1.0, 1.7, n) for n in ns]


def _close(got, want, tol=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _phi(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_level0_factors_match_poisson_mg(name, dtype, periodic):
    import jax.numpy as jnp
    from petibm_tpu.linalg.mg import PoissonMG

    ns = SHAPES[name]
    flags = [periodic] + [False] * (len(ns) - 1)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    want = PoissonMG(_widths(ns), flags, dtype=jdt, scale=0.01).levels[0]
    got = poisson_level0(_widths(ns), flags, dtype=dtype, device="cpu",
                         scale=0.01)
    assert got.shape == want.shape
    assert got.periodic == want.periodic
    for a, b in zip(got.c1d + got.w1d, want.c1d + want.w1d):
        assert a.dtype == dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_twin_matches_pallas_interpret(name):
    import jax.numpy as jnp
    import petibm_tpu.operators.pallas_stencil as ps
    from petibm_tpu.linalg.mg import PoissonMG

    ns = SHAPES[name]
    mg = PoissonMG(_widths(ns), [False] * len(ns), dtype=jnp.float64,
                   scale=0.01)
    phi = _phi(mg.levels[0].shape)
    want = ps.poisson_apply_separable(jnp.asarray(phi),
                                      ps.separable_aux(mg.levels[0]),
                                      interpret=True)
    level = poisson_level0(_widths(ns), [False] * len(ns),
                           dtype=torch.float64, device="cpu", scale=0.01)
    _close(cs.poisson_apply_separable_ref(torch.as_tensor(phi), level), want)


@pytest.mark.parametrize("name", ["2d", "3d"])
def test_twin_matches_jax_poisson_closure(name, tmp_path):
    """The twin equals the JAX solver's -A_poisson (= -D B1 G) stencil
    closure on a stretched wall-bounded mesh."""
    import jax.numpy as jnp
    from petibm_tpu.boundary import BoundarySet
    from petibm_tpu.mesh import StaggeredMesh
    from petibm_tpu.operators import (make_bn, make_divergence,
                                      make_gradient, make_laplacian)
    from petibm_tpu.types import Field

    ns = SHAPES[name]
    dirs = ("x", "y", "z")[:len(ns)]
    cfg = {"mesh": [{"direction": d, "start": 0.0, "subDomains": [
        {"end": 0.5, "cells": n // 2, "stretchRatio": 1.1},
        {"end": 1.5, "cells": n - n // 2, "stretchRatio": 0.95}]}
        for d, n in zip(dirs, ns)],
        "flow": {"nu": 0.01, "boundaryConditions": [
            {"location": f"{d}{side}",
             **{f: ["DIRICHLET", 0.0] for f in ("u", "v", "w")[:len(ns)]}}
            for d in dirs for side in ("Minus", "Plus")]}}
    mesh = StaggeredMesh(cfg)
    bcs = BoundarySet(mesh, cfg)
    dt = 0.01
    grad = make_gradient(mesh, jnp.float64)
    div = make_divergence(mesh, bcs, jnp.float64)
    bn = make_bn(make_laplacian(mesh, bcs, jnp.float64), dt, 0.005, 1)
    phi = _phi(mesh.shape(Field.P), seed=3)
    want = -div(bn(grad(jnp.asarray(phi))), None, homogeneous=True)
    level = poisson_level0(mesh.dxp, mesh.periodic, dtype=torch.float64,
                           device="cpu", scale=dt)
    _close(cs.poisson_apply_separable(torch.as_tensor(phi), level), want)


def test_wrapper_on_cpu_runs_twin_without_counting():
    level = poisson_level0(_widths([48, 32]), [False, False],
                           dtype=torch.float32, device="cpu", scale=0.01)
    phi = torch.as_tensor(_phi(level.shape), dtype=torch.float32)
    before = cs.poisson_apply_separable.launches
    got = cs.poisson_apply_separable(phi, level)
    assert cs.poisson_apply_separable.launches == before
    assert torch.equal(got, cs.poisson_apply_separable_ref(phi, level))
    fused = cs.make_cuda_poisson(level)
    assert torch.equal(fused(phi), got)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    level = poisson_level0(_widths([12, 10]), [False, False],
                           dtype=torch.float64, device="cpu")
    phi = torch.zeros(level.shape, dtype=torch.float64)
    with pytest.raises(ValueError):
        cs.poisson_apply_separable(torch.zeros(9, 12, dtype=torch.float64),
                                   level)
    with pytest.raises(ValueError):  # factors of another dtype
        cs.poisson_apply_separable(phi.float(), level)
    with pytest.raises(TypeError):
        lvl16 = poisson_level0(_widths([12, 10]), [False, False],
                               dtype=torch.float16, device="cpu")
        cs.poisson_apply_separable(phi.half(), lvl16)
    periodic = poisson_level0(_widths([12, 10]), [True, False],
                              dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError):
        cs.poisson_apply_separable(phi, periodic)
    assert cs.make_cuda_poisson(periodic) is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_cuda_kernel_matches_twin(name, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    ns = SHAPES[name]
    level = poisson_level0(_widths(ns), [False] * len(ns), dtype=dtype,
                           device="cuda", scale=0.01)
    phi = torch.as_tensor(_phi(level.shape), dtype=dtype, device="cuda")
    before = cs.poisson_apply_separable.launches
    got = cs.poisson_apply_separable(phi, level)
    torch.cuda.synchronize()
    assert cs.poisson_apply_separable.launches == before + 1
    want = cs.poisson_apply_separable_ref(phi, level)
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err <= tol


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    level = poisson_level0(_widths([12, 10]), [False, False],
                           dtype=torch.float32, device="cuda")
    phi = torch.zeros((10, 24), dtype=torch.float32, device="cuda")[:, ::2]
    assert not phi.is_contiguous()
    with pytest.raises(ValueError):
        cs.poisson_apply_separable(phi, level)
    cpu_level = poisson_level0(_widths([12, 10]), [False, False],
                               dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError):  # factors on another device
        cs.poisson_apply_separable(phi.contiguous(), cpu_level)
