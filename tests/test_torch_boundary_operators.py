"""The port's boundary set and stencil operators against the JAX closures
(float64, 1e-12): extend, update_eqs, update_ghost_values, gradient,
divergence, the Laplacian with its O(surface) correction, convection and
B_N, in 2D and 3D, with and without periodic axes, over every BC type."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petibm_tpu.boundary as jb
import petibm_tpu.mesh as jm
import petibm_tpu.operators as jops
import petibm_tpu_torch.boundary as tb
import petibm_tpu_torch.mesh as tm
from petibm_tpu.types import Field
from petibm_tpu_torch.operators.bn import make_bn
from petibm_tpu_torch.operators.convection import make_convection
from petibm_tpu_torch.operators.stencil import (make_divergence,
                                                make_gradient, make_laplacian)

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
NAMES = ("u", "v", "w")


def _axis(d, n, ratio=1.0, start=0.0, end=1.0):
    return {"direction": d, "start": start,
            "subDomains": [{"end": end, "cells": n, "stretchRatio": ratio}]}


def _bcs(dim, table):
    """table: location -> BC type; values are type-dependent constants."""
    value = {"DIRICHLET": 0.7, "NEUMANN": -0.3, "CONVECTIVE": 1.1,
             "PERIODIC": 0.0}
    out = []
    for loc, bct in table.items():
        entry = {"location": loc}
        for f in NAMES[:dim]:
            entry[f] = [bct, value[bct] * (1.0 + 0.1 * NAMES.index(f))]
        out.append(entry)
    return out


CONFIGS = {
    # every BC type on a stretched 2D mesh
    "2d_mixed": ([_axis("x", 11, 1.1), _axis("y", 9, 0.93, -1.0)],
                 {"xMinus": "DIRICHLET", "xPlus": "CONVECTIVE",
                  "yMinus": "NEUMANN", "yPlus": "DIRICHLET"}),
    "2d_xperiodic": ([_axis("x", 10), _axis("y", 7, 1.08)],
                     {"xMinus": "PERIODIC", "xPlus": "PERIODIC",
                      "yMinus": "DIRICHLET", "yPlus": "CONVECTIVE"}),
    "3d_mixed": ([_axis("x", 8, 1.1), _axis("y", 7), _axis("z", 6, 0.9)],
                 {"xMinus": "DIRICHLET", "xPlus": "CONVECTIVE",
                  "yMinus": "NEUMANN", "yPlus": "DIRICHLET",
                  "zMinus": "DIRICHLET", "zPlus": "NEUMANN"}),
    "3d_zperiodic": ([_axis("x", 7, 1.12), _axis("y", 6), _axis("z", 8)],
                     {"xMinus": "DIRICHLET", "xPlus": "CONVECTIVE",
                      "yMinus": "DIRICHLET", "yPlus": "NEUMANN",
                      "zMinus": "PERIODIC", "zPlus": "PERIODIC"}),
    "3d_xzperiodic": ([_axis("x", 6), _axis("y", 7, 1.1), _axis("z", 5)],
                      {"xMinus": "PERIODIC", "xPlus": "PERIODIC",
                       "yMinus": "DIRICHLET", "yPlus": "CONVECTIVE",
                       "zMinus": "PERIODIC", "zPlus": "PERIODIC"}),
}


class Case:
    """One config on both packages with random fields and BC states."""

    def __init__(self, name, seed=0):
        axes, table = CONFIGS[name]
        dim = len(axes)
        self.cfg = {"mesh": axes, "flow": {"nu": 0.01,
                                           "boundaryConditions":
                                           _bcs(dim, table)}}
        self.jmesh = jm.StaggeredMesh(self.cfg)
        self.tmesh = tm.StaggeredMesh(self.cfg)
        self.jbc = jb.BoundarySet(self.jmesh, self.cfg)
        self.tbc = tb.BoundarySet(self.tmesh, self.cfg)
        self.dim = dim
        rng = np.random.default_rng(seed)
        self.q = {NAMES[c]: rng.standard_normal(self.jmesh.shape(Field(c)))
                  for c in range(dim)}
        self.q2 = {k: rng.standard_normal(v.shape) for k, v in self.q.items()}
        self.p = rng.standard_normal(self.jmesh.shape(Field.P))
        # a developed BC state: random a1 and ghost values per face
        init = self.jbc.init_state({k: jnp.asarray(v)
                                    for k, v in self.q.items()})
        self.bcstate = {key: {k: rng.standard_normal(np.shape(v))
                              for k, v in st.items()}
                        for key, st in init.items()}

    def j(self, tree):
        return _map(tree, jnp.asarray)

    def t(self, tree):
        return _map(tree, torch.as_tensor)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _close(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * max(1.0, np.abs(want).max()))


CASES = sorted(CONFIGS)


@pytest.mark.parametrize("name", CASES)
def test_boundary_state_updates(name):
    c = Case(name)
    _close(c.tbc.init_state(c.t(c.q), torch.float64),
           c.jbc.init_state(c.j(c.q), jnp.float64))
    _close(c.tbc.update_eqs(c.t(c.bcstate), c.t(c.q2), 0.013),
           c.jbc.update_eqs(c.j(c.bcstate), c.j(c.q2), 0.013))
    _close(c.tbc.update_ghost_values(c.t(c.bcstate), c.t(c.q2)),
           c.jbc.update_ghost_values(c.j(c.bcstate), c.j(c.q2)))
    assert sorted(c.tbc.specs) == sorted(c.jbc.specs)
    for k, s in c.jbc.specs.items():
        t = c.tbc.specs[k]
        assert (t.key, t.a0, t.normal, t.value, int(t.type)) == (
            s.key, s.a0, s.normal, s.value, int(s.type))
        assert t.dL == pytest.approx(s.dL, rel=1e-12)


@pytest.mark.parametrize("homogeneous", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_extend(name, homogeneous):
    c = Case(name)
    for f in range(c.dim):
        arr = c.q[NAMES[f]]
        dir_sets = [None] + [(d,) for d in range(c.dim)]
        if c.dim == 3:
            dir_sets.append((0, 2))
        for dirs in dir_sets:
            _close(c.tbc.extend(torch.as_tensor(arr), f, c.t(c.bcstate),
                                homogeneous=homogeneous, dirs=dirs),
                   c.jbc.extend(jnp.asarray(arr), f, c.j(c.bcstate),
                                homogeneous=homogeneous, dirs=dirs))


@pytest.mark.parametrize("name", CASES)
def test_gradient_divergence(name):
    c = Case(name)
    tg = make_gradient(c.tmesh, **F64)
    jg = jops.make_gradient(c.jmesh, jnp.float64)
    _close(tg(torch.as_tensor(c.p)), jg(jnp.asarray(c.p)))
    td = make_divergence(c.tmesh, c.tbc, **F64)
    jd = jops.make_divergence(c.jmesh, c.jbc, jnp.float64)
    _close(td(c.t(c.q), c.t(c.bcstate)), jd(c.j(c.q), c.j(c.bcstate)))
    _close(td(c.t(c.q), None, homogeneous=True),
           jd(c.j(c.q), None, homogeneous=True))


@pytest.mark.parametrize("name", CASES)
def test_laplacian_and_correction(name):
    c = Case(name)
    tl = make_laplacian(c.tmesh, c.tbc, **F64)
    jl = jops.make_laplacian(c.jmesh, c.jbc, jnp.float64)
    _close(tl(c.t(c.q), c.t(c.bcstate)), jl(c.j(c.q), c.j(c.bcstate)))
    _close(tl(c.t(c.q), None, homogeneous=True),
           jl(c.j(c.q), None, homogeneous=True))
    _close(tl.correction(c.t(c.bcstate)), jl.correction(c.j(c.bcstate)))
    # the correction is the a1 part: L(q, bc) - L(q, hom)
    full = tl(c.t(c.q), c.t(c.bcstate))
    hom = tl(c.t(c.q), None, homogeneous=True)
    corr = tl.correction(c.t(c.bcstate))
    for k in full:
        np.testing.assert_allclose((full[k] - hom[k]).numpy(),
                                   corr[k].numpy(), atol=1e-12)


@pytest.mark.parametrize("name", CASES)
def test_convection(name):
    c = Case(name)
    tc = make_convection(c.tmesh, c.tbc, **F64)
    jc = jops.make_convection(c.jmesh, c.jbc, jnp.float64)
    _close(tc(c.t(c.q), c.t(c.bcstate)), jc(c.j(c.q), c.j(c.bcstate)))


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("name", ["2d_mixed", "3d_zperiodic"])
def test_bn(name, order):
    c = Case(name)
    tl = make_laplacian(c.tmesh, c.tbc, **F64)
    jl = jops.make_laplacian(c.jmesh, c.jbc, jnp.float64)
    tbn = make_bn(tl, 0.02, 0.5 * 0.01, order)
    jbn = jops.make_bn(jl, 0.02, 0.5 * 0.01, order)
    _close(tbn(c.t(c.q)), jbn(c.j(c.q)))
    with pytest.raises(ValueError):
        make_bn(tl, 0.02, 0.005, 0)
