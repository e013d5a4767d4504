"""K2, the 3D 7-point apply with per-axis coefficients, in its two uses:
K2a (the implicit momentum operator, ``make_cuda_momentum``) and K2b (the
scaled 3D Poisson apply, ``make_cuda_poisson_zblocked``).

On the CPU the wrapper runs its plain twin.  The twin is held, in float64,
to 1e-11 of the field's maximum against a brute-force loop, the Pallas
kernels in interpret mode (``make_pallas_momentum``,
``make_pallas_poisson_zblocked``; each test asserts that the JAX factory
built its kernel), the JAX momentum stencil closure and
``PoissonMG.apply_op``, on non-cubic stretched grids with mixed periodic
axes, one with a z extent the JAX block grid does not tile.  The CUDA
kernel is held to the twin on a card:

    python -m pytest tests/test_torch_zblocked_kernel.py --noconftest -m cuda
"""

import itertools

import numpy as np
import pytest
import torch

from petibm_tpu_torch.linalg.mg import poisson_level0
from petibm_tpu_torch.operators import cuda_stencil as cs

torch.set_num_threads(2)

TOL = 1e-11


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _axis(d, n, ratio=1.0, periodic=False):
    return {"direction": d, "start": 0.0, "subDomains": [
        {"end": 0.4, "cells": n // 2, "stretchRatio": ratio},
        {"end": 1.0, "cells": n - n // 2, "stretchRatio": 1.0 / ratio}]}


def _bcs(kinds):
    """kinds: location -> (u, v, w) BC types; value 0.3 on every face."""
    return [{"location": loc, **{f: [t, 0.0 if t == "PERIODIC" else 0.3]
                                 for f, t in zip("uvw", types)}}
            for loc, types in kinds.items()]


MOMENTUM_MESHES = {
    # (x, y, z) cells, stretch ratio, periodic axes; z = 16 periodic
    "zperiodic": ((10, 12, 16), 1.0, (False, False, True)),
    # z = 13 walled: the JAX block grid (bz 8) does not tile it
    "walled_stretched": ((11, 9, 13), 1.1, (False, False, False)),
    "xy_periodic": ((8, 6, 12), 1.05, (True, True, False)),
}


def momentum_config(name):
    cells, ratio, periodic = MOMENTUM_MESHES[name]
    kinds = {}
    types = {"x": ("DIRICHLET", "NEUMANN", "DIRICHLET"),
             "y": ("NEUMANN", "DIRICHLET", "DIRICHLET"),
             "z": ("DIRICHLET", "DIRICHLET", "CONVECTIVE")}
    for d, per in zip("xyz", periodic):
        for side in ("Minus", "Plus"):
            kinds[d + side] = (("PERIODIC",) * 3 if per else
                               types[d] if side == "Minus"
                               else ("DIRICHLET", "CONVECTIVE", "NEUMANN"))
    return {"mesh": [_axis(d, n, 1.0 if per else ratio)
                     for d, n, per in zip("xyz", cells, periodic)],
            "flow": {"nu": 0.01, "boundaryConditions": _bcs(kinds)}}


def _random_q(mesh, seed):
    from petibm_tpu_torch.types import Field

    rng = np.random.default_rng(seed)
    return {name: rng.standard_normal(mesh.shape(Field(c)))
            for c, name in enumerate("uvw")}


@pytest.mark.parametrize("name", sorted(MOMENTUM_MESHES))
def test_momentum_twin_matches_pallas_and_jax_closure(name):
    import jax.numpy as jnp
    from petibm_tpu.boundary import BoundarySet as JBC
    from petibm_tpu.mesh import StaggeredMesh as JMesh
    from petibm_tpu.operators.pallas_stencil import make_pallas_momentum
    from petibm_tpu.operators.stencil import make_laplacian
    from petibm_tpu_torch.boundary import BoundarySet
    from petibm_tpu_torch.mesh import StaggeredMesh

    cfg = momentum_config(name)
    dt, cnu = 0.01, 0.037
    jmesh = JMesh(cfg)
    jbcs = JBC(jmesh, cfg)
    pallas = make_pallas_momentum(jmesh, jbcs, dt, cnu, jnp.float64,
                                  interpret=True)
    assert pallas is not None, "the JAX factory built no kernel"
    mesh = StaggeredMesh(cfg)
    port = cs.make_cuda_momentum(mesh, BoundarySet(mesh, cfg), dt, cnu,
                                 dtype=torch.float64, device="cpu")
    q = _random_q(mesh, seed=3)
    got = port({k: torch.as_tensor(v) for k, v in q.items()})
    want_pallas = pallas({k: jnp.asarray(v) for k, v in q.items()})
    lap = make_laplacian(jmesh, jbcs, jnp.float64)
    lu = lap({k: jnp.asarray(v) for k, v in q.items()}, None,
             homogeneous=True)
    for key in "uvw":
        assert _rel(got[key], want_pallas[key]) <= TOL
        want = q[key] / dt - cnu * np.asarray(lu[key])
        assert _rel(got[key], want) <= TOL


# (x, y, z) cells and periodic flags: the grids of tests/test_pallas.py,
# and a walled z = 13 that the JAX block grid does not tile
POISSON_GRIDS = {
    "walled": ([12, 10, 32], [False, False, False]),
    "xy_periodic": ([13, 16, 32], [True, True, False]),
    "yz_periodic": ([16, 10, 24], [False, True, True]),
    "z13_y_periodic": ([10, 9, 13], [False, True, False]),
}


def _widths(ns):
    return [np.geomspace(1.0, 1.7, n) for n in ns]


@pytest.mark.parametrize("name", sorted(POISSON_GRIDS))
def test_poisson_twin_matches_pallas_and_apply_op(name):
    import jax.numpy as jnp
    from petibm_tpu.linalg.mg import PoissonMG
    from petibm_tpu.operators.pallas_stencil import (
        make_pallas_poisson_zblocked)

    ns, per = POISSON_GRIDS[name]
    mg = PoissonMG(_widths(ns), per, dtype=jnp.float64, scale=0.01)
    pallas = make_pallas_poisson_zblocked(mg, interpret=True)
    assert pallas is not None, "the JAX factory built no kernel"
    level = poisson_level0(_widths(ns), per, dtype=torch.float64,
                           device="cpu", scale=0.01)
    port = cs.make_cuda_poisson_zblocked(level)
    phi = np.random.default_rng(5).standard_normal(level.shape)
    got = port(torch.as_tensor(phi))
    assert _rel(got, pallas(jnp.asarray(phi))) <= TOL
    assert _rel(got, mg.apply_op(0, jnp.asarray(phi))) <= TOL


def _brute_force(f, vecs, periodic, scale):
    """The K2 formula cell by cell (numpy, float64)."""
    nz, ny, nx = f.shape
    n = (nz, ny, nx)
    out = np.zeros_like(f)
    for k, j, i in itertools.product(range(nz), range(ny), range(nx)):
        idx = (k, j, i)
        acc = f[idx] * (vecs["Dz"][k] + vecs["Dy"][j] + vecs["Dx"][i])
        for ax, tag in enumerate("zyx"):
            for key, step in (("CN", -1), ("CP", 1)):
                m = idx[ax] + step
                if 0 <= m < n[ax] or periodic[ax]:
                    nb = list(idx)
                    nb[ax] = m % n[ax]
                    acc += vecs[key + tag][idx[ax]] * f[tuple(nb)]
        if scale is not None:
            acc *= scale[0][k] * scale[1][j] * scale[2][i]
        out[idx] = acc
    return out


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("periodic",
                         list(itertools.product([False, True], repeat=3)))
def test_twin_matches_brute_force(periodic, scaled):
    rng = np.random.default_rng(11)
    shape = (5, 4, 3)
    f = rng.standard_normal(shape)
    vecs = {k: rng.standard_normal(shape["zyx".index(k[-1])])
            for k in cs.ZBLOCKED_KEYS}
    scale = (tuple(rng.uniform(0.5, 1.5, n) for n in shape)
             if scaled else None)
    got = cs.zblocked_helmholtz_apply(
        torch.as_tensor(f), {k: torch.as_tensor(v) for k, v in vecs.items()},
        periodic, None if scale is None
        else tuple(torch.as_tensor(s) for s in scale))
    assert _rel(got, _brute_force(f, vecs, periodic, scale)) <= 1e-13


def test_wrapper_on_cpu_runs_twin_without_counting():
    from petibm_tpu_torch.boundary import BoundarySet
    from petibm_tpu_torch.mesh import StaggeredMesh

    cfg = momentum_config("zperiodic")
    mesh = StaggeredMesh(cfg)
    A = cs.make_cuda_momentum(mesh, BoundarySet(mesh, cfg), 0.01, 0.02,
                              dtype=torch.float32, device="cpu")
    u = torch.as_tensor(_random_q(mesh, 1)["u"], dtype=torch.float32)
    before = cs.zblocked_helmholtz_apply.launches
    got = cs.zblocked_helmholtz_apply(u, A.vecs["u"], A.periodic)
    assert cs.zblocked_helmholtz_apply.launches == before
    assert got.dtype == torch.float32
    assert torch.equal(got, cs.zblocked_helmholtz_apply_ref(
        u, A.vecs["u"], A.periodic))
    assert torch.equal(A({"u": u, "v": torch.zeros(mesh.shape(1)),
                          "w": torch.zeros(mesh.shape(2))})["u"], got)


def test_factories_decline_2d():
    from petibm_tpu_torch.boundary import BoundarySet
    from petibm_tpu_torch.mesh import StaggeredMesh

    cfg = {"mesh": [_axis(d, 8) for d in "xy"],
           "flow": {"nu": 0.01, "boundaryConditions": _bcs(
               {loc: ("DIRICHLET",) * 3 for loc in
                ("xMinus", "xPlus", "yMinus", "yPlus")})}}
    mesh = StaggeredMesh(cfg)
    assert cs.make_cuda_momentum(mesh, BoundarySet(mesh, cfg), 0.1, 0.1,
                                 dtype=torch.float64, device="cpu") is None
    level = poisson_level0(_widths([8, 8]), [True, False],
                           dtype=torch.float64, device="cpu")
    assert cs.make_cuda_poisson_zblocked(level) is None


def test_wrapper_rejects_what_the_kernel_does_not_take():
    level = poisson_level0(_widths([6, 5, 4]), [True, False, False],
                           dtype=torch.float64, device="cpu")
    k2b = cs.make_cuda_poisson_zblocked(level)
    vecs, per, scale = k2b.vecs, k2b.periodic, k2b.scale
    phi = torch.zeros(level.shape, dtype=torch.float64)
    with pytest.raises(ValueError):  # 2D field
        cs.zblocked_helmholtz_apply(phi[0], vecs, per, scale)
    with pytest.raises(ValueError):  # transposed field
        cs.zblocked_helmholtz_apply(phi.transpose(0, 2).contiguous(), vecs,
                                    per, scale)
    with pytest.raises(ValueError):  # coefficients of another dtype
        cs.zblocked_helmholtz_apply(phi.float(), vecs, per, scale)
    with pytest.raises(TypeError):
        cs.zblocked_helmholtz_apply(
            phi.half(), {k: v.half() for k, v in vecs.items()}, per)
    with pytest.raises(ValueError):  # two scale vectors
        cs.zblocked_helmholtz_apply(phi, vecs, per, scale[:2])
    with pytest.raises(ValueError):  # two periodic flags
        cs.zblocked_helmholtz_apply(phi, vecs, per[:2], scale)
    with pytest.raises(KeyError):
        cs.zblocked_helmholtz_apply(
            phi, {k: v for k, v in vecs.items() if k != "CPx"}, per)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("use", ["momentum", "poisson"])
def test_cuda_kernel_matches_twin(use, dtype, tol):
    _cuda_or_skip()
    from petibm_tpu_torch.boundary import BoundarySet
    from petibm_tpu_torch.mesh import StaggeredMesh

    if use == "momentum":
        cfg = momentum_config("walled_stretched")
        mesh = StaggeredMesh(cfg)
        A = cs.make_cuda_momentum(mesh, BoundarySet(mesh, cfg), 0.01, 0.02,
                                  dtype=dtype, device="cuda")
        f = torch.as_tensor(_random_q(mesh, 2)["w"], dtype=dtype,
                            device="cuda")
        args = (A.vecs["w"], A.periodic, None)
    else:
        ns, per = POISSON_GRIDS["yz_periodic"]
        level = poisson_level0(_widths(ns), per, dtype=dtype, device="cuda",
                               scale=0.01)
        k2b = cs.make_cuda_poisson_zblocked(level)
        f = torch.as_tensor(np.random.default_rng(2).standard_normal(
            level.shape), dtype=dtype, device="cuda")
        args = (k2b.vecs, k2b.periodic, k2b.scale)
    before = cs.zblocked_helmholtz_apply.launches
    got = cs.zblocked_helmholtz_apply(f, *args)
    torch.cuda.synchronize()
    assert cs.zblocked_helmholtz_apply.launches == before + 1
    want = cs.zblocked_helmholtz_apply_ref(f, *args)
    assert float((got - want).abs().max() / want.abs().max()) <= tol


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    _cuda_or_skip()
    level = poisson_level0(_widths([6, 5, 4]), [True, False, False],
                           dtype=torch.float32, device="cuda")
    k2b = cs.make_cuda_poisson_zblocked(level)
    phi = torch.zeros((4, 5, 12), dtype=torch.float32, device="cuda")[:, :, ::2]
    assert not phi.is_contiguous()
    with pytest.raises(ValueError):
        cs.zblocked_helmholtz_apply(phi, k2b.vecs, k2b.periodic, k2b.scale)
    with pytest.raises(ValueError):  # coefficients on another device
        cs.zblocked_helmholtz_apply(
            phi.contiguous(), {k: v.cpu() for k, v in k2b.vecs.items()},
            k2b.periodic)
