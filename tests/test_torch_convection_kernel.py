"""K3, the 3D divergence-form convection (one launch per velocity
component), through ``make_cuda_convection``.

On the CPU the wrapper runs its plain twin.  The twin is held, in float64,
to 1e-12 of each component's maximum against the Pallas kernel in
interpret mode (``make_pallas_convection``; each test asserts that the JAX
factory built its kernel), the JAX convection closure and the port's own
``operators/convection.py`` closure, on non-cubic stretched grids with
mixed periodic and wall axes (the mesh of tests/test_pallas.py among
them).  The CUDA kernel is held to the twin on a card:

    python -m pytest tests/test_torch_convection_kernel.py --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

from petibm_tpu_torch.operators import cuda_stencil as cs

torch.set_num_threads(2)

TOL = 1e-12


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _axis(d, n, ratio=1.0):
    return {"direction": d, "start": 0.0, "subDomains": [
        {"end": 1.0, "cells": n, "stretchRatio": ratio}]}


def _faces(d, u, v, w):
    return [{"location": d + side, "u": u, "v": v, "w": w}
            for side in ("Minus", "Plus")]


PER = ["PERIODIC", 0.0]
MESHES = {
    # tests/test_pallas.py:170-209: y periodic, z stretched, mixed walls
    "test_pallas": ([_axis("x", 12), _axis("y", 10), _axis("z", 13, 1.02)],
                    _faces("x", ["DIRICHLET", 0.3], ["DIRICHLET", 0.0],
                           ["DIRICHLET", 0.0])
                    + _faces("y", PER, PER, PER)
                    + [{"location": "zMinus", "u": ["NEUMANN", 0.0],
                        "v": ["DIRICHLET", 0.0], "w": ["DIRICHLET", 0.1]},
                       {"location": "zPlus", "u": ["DIRICHLET", 1.0],
                        "v": ["DIRICHLET", 0.0], "w": ["DIRICHLET", 0.0]}]),
    "periodic": ([_axis("x", 8), _axis("y", 10), _axis("z", 12)],
                 _faces("x", PER, PER, PER) + _faces("y", PER, PER, PER)
                 + _faces("z", PER, PER, PER)),
    "walled_stretched": (
        [_axis("x", 9, 1.08), _axis("y", 11, 0.95), _axis("z", 10, 1.05)],
        [{"location": "xMinus", "u": ["DIRICHLET", 1.0],
          "v": ["DIRICHLET", 0.0], "w": ["DIRICHLET", 0.0]},
         {"location": "xPlus", "u": ["CONVECTIVE", 1.0],
          "v": ["CONVECTIVE", 1.0], "w": ["CONVECTIVE", 1.0]}]
        + _faces("y", ["DIRICHLET", 1.0], ["DIRICHLET", 0.0],
                 ["NEUMANN", 0.0])
        + _faces("z", ["NEUMANN", 0.0], ["DIRICHLET", 0.2],
                 ["DIRICHLET", 0.0])),
}


def _config(name):
    mesh, bcs = MESHES[name]
    return {"mesh": mesh, "flow": {"nu": 0.01, "boundaryConditions": bcs}}


def _random_q(mesh, seed):
    from petibm_tpu_torch.types import Field

    rng = np.random.default_rng(seed)
    return {name: rng.standard_normal(mesh.shape(Field(c)))
            for c, name in enumerate("uvw")}


def _port(name, dtype=torch.float64, device="cpu"):
    from petibm_tpu_torch.boundary import BoundarySet
    from petibm_tpu_torch.mesh import StaggeredMesh

    cfg = _config(name)
    mesh = StaggeredMesh(cfg)
    bcs = BoundarySet(mesh, cfg)
    return mesh, bcs, cs.make_cuda_convection(mesh, bcs, dtype=dtype,
                                              device=device)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_twin_matches_pallas_and_closures(name):
    import jax.numpy as jnp
    from petibm_tpu.boundary import BoundarySet as JBC
    from petibm_tpu.mesh import StaggeredMesh as JMesh
    from petibm_tpu.operators.convection import make_convection as jconv
    from petibm_tpu.operators.pallas_stencil import make_pallas_convection
    from petibm_tpu_torch.operators.convection import make_convection

    cfg = _config(name)
    jmesh = JMesh(cfg)
    jbcs = JBC(jmesh, cfg)
    pallas = make_pallas_convection(jmesh, jbcs, jnp.float64, interpret=True)
    assert pallas is not None, "the JAX factory built no kernel"
    mesh, bcs, port = _port(name)
    q = _random_q(mesh, seed=7)
    jq = {k: jnp.asarray(v) for k, v in q.items()}
    jstate = jbcs.init_state(jq)
    tq = {k: torch.as_tensor(v) for k, v in q.items()}
    tstate = bcs.init_state(tq)
    got = port(tq, tstate)
    want_pallas = pallas(jq, jstate)
    want_jax = jconv(jmesh, jbcs, jnp.float64)(jq, jstate)
    want_port = make_convection(mesh, bcs, dtype=torch.float64,
                                device="cpu")(tq, tstate)
    for key in "uvw":
        assert _rel(got[key], want_pallas[key]) <= TOL
        assert _rel(got[key], want_jax[key]) <= TOL
        assert _rel(got[key], want_port[key]) <= TOL


def test_wrapper_on_cpu_runs_twin_without_counting():
    mesh, bcs, conv = _port("walled_stretched", dtype=torch.float32)
    q = {k: torch.as_tensor(v, dtype=torch.float32)
         for k, v in _random_q(mesh, 3).items()}
    state = bcs.init_state(q)
    before = cs.convection3d_apply.launches
    got = conv(q, state)
    assert cs.convection3d_apply.launches == before
    ext = [bcs.extend(q[k], e, state) for e, k in enumerate("uvw")]
    for c, key in enumerate("uvw"):
        assert got[key].dtype == torch.float32
        assert torch.equal(got[key], cs.convection3d_apply_ref(
            ext, c, conv.inv_dl[c]))


def test_factory_declines_2d():
    from petibm_tpu_torch.boundary import BoundarySet
    from petibm_tpu_torch.mesh import StaggeredMesh

    cfg = {"mesh": [_axis("x", 6), _axis("y", 5)],
           "flow": {"nu": 0.01, "boundaryConditions":
                    [{"location": loc, "u": ["DIRICHLET", 0.0],
                      "v": ["DIRICHLET", 0.0]}
                     for loc in ("xMinus", "xPlus", "yMinus", "yPlus")]}}
    mesh = StaggeredMesh(cfg)
    assert cs.make_cuda_convection(mesh, BoundarySet(mesh, cfg),
                                   dtype=torch.float64, device="cpu") is None


def test_wrapper_rejects_what_the_kernel_does_not_take():
    mesh, bcs, conv = _port("test_pallas")
    q = {k: torch.as_tensor(v) for k, v in _random_q(mesh, 4).items()}
    state = bcs.init_state(q)
    ext = [bcs.extend(q[k], e, state) for e, k in enumerate("uvw")]
    iv = conv.inv_dl
    with pytest.raises(ValueError):  # no component 3
        cs.convection3d_apply(ext, 3, iv[0])
    with pytest.raises(ValueError):  # 2D arrays
        cs.convection3d_apply([e[0] for e in ext], 0, iv[0])
    with pytest.raises(ValueError):  # another component's 1/dl
        cs.convection3d_apply(ext, 2, iv[0])
    with pytest.raises(ValueError):  # an advecting array cut too short
        cs.convection3d_apply([ext[0], ext[1][:, :-2, :], ext[2]], 0, iv[0])
    with pytest.raises(ValueError):  # mixed dtypes
        cs.convection3d_apply([ext[0], ext[1].float(), ext[2]], 0, iv[0])
    with pytest.raises(TypeError):
        cs.convection3d_apply([e.half() for e in ext], 0,
                              tuple(v.half() for v in iv[0]))


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("name", ["test_pallas", "walled_stretched"])
def test_cuda_kernel_matches_twin(name, dtype, tol):
    _cuda_or_skip()
    mesh, bcs, conv = _port(name, dtype=dtype, device="cuda")
    q = {k: torch.as_tensor(v, dtype=dtype, device="cuda")
         for k, v in _random_q(mesh, 5).items()}
    state = bcs.init_state(q)
    before = cs.convection3d_apply.launches
    got = conv(q, state)
    torch.cuda.synchronize()
    assert cs.convection3d_apply.launches == before + 3
    ext = [bcs.extend(q[k], e, state) for e, k in enumerate("uvw")]
    for c, key in enumerate("uvw"):
        want = cs.convection3d_apply_ref(ext, c, conv.inv_dl[c])
        assert float((got[key] - want).abs().max()
                     / want.abs().max()) <= tol


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    _cuda_or_skip()
    mesh, bcs, conv = _port("periodic", dtype=torch.float32, device="cuda")
    q = {k: torch.as_tensor(v, dtype=torch.float32, device="cuda")
         for k, v in _random_q(mesh, 6).items()}
    ext = [bcs.extend(q[k], e, bcs.init_state(q))
           for e, k in enumerate("uvw")]
    strided = torch.zeros(tuple(2 * s for s in ext[0].shape),
                          device="cuda")[::2, ::2, ::2]
    assert not strided.is_contiguous()
    with pytest.raises(ValueError):
        cs.convection3d_apply([strided, ext[1], ext[2]], 0, conv.inv_dl[0])
    with pytest.raises(ValueError):  # 1/dl on another device
        cs.convection3d_apply(ext, 0, tuple(v.cpu() for v in conv.inv_dl[0]))
