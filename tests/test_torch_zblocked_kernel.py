"""K2, the 3D 7-point apply with per-axis coefficients, in its two uses:
K2a (the implicit momentum operator, ``make_cuda_momentum``) and K2b (the
scaled 3D Poisson apply, ``make_cuda_poisson_zblocked``).

On the CPU the wrapper runs its plain twin.  The twin is held, in float64,
to 1e-11 of the field's maximum against a brute-force loop, the Pallas
kernels in interpret mode (``make_pallas_momentum``,
``make_pallas_poisson_zblocked``; each test asserts that the JAX factory
built its kernel), the JAX momentum stencil closure and
``PoissonMG.apply_op``, on non-cubic stretched grids with mixed periodic
axes, one with a z extent the JAX block grid does not tile.  The CPU tests
also hold ``launch_plan`` (its grid covers every cell once, no block is
empty, the z split gives the blocks it promises) and ``plan_error``, the
C entry's refusals.  On a card the kernel is held to the twin bit for bit
(every plan a shape admits, ragged tiles, extents 1-3, every periodic
combination, scaled or not, float32 and float64, and a field between NaN
planes), the first design (one thread per cell) to 1e-6 / 1e-13, and the
C entry's refusals to ``plan_error``:

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


def _vecs_and_scale(rng, shape, scaled):
    vecs = {k: rng.standard_normal(shape["zyx".index(k[-1])])
            for k in cs.ZBLOCKED_KEYS}
    scale = (tuple(rng.uniform(0.5, 1.5, n) for n in shape)
             if scaled else None)
    return vecs, scale


# (nz, ny, nx): a box, and extents 1, 2 and 3 on every axis
BRUTE_SHAPES = [(5, 4, 3), (1, 2, 3), (3, 1, 2), (2, 3, 1)]


@pytest.mark.parametrize("shape", BRUTE_SHAPES)
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("periodic",
                         list(itertools.product([False, True], repeat=3)))
def test_twin_matches_brute_force(periodic, scaled, shape):
    rng = np.random.default_rng(11)
    f = rng.standard_normal(shape)
    vecs, scale = _vecs_and_scale(rng, shape, scaled)
    got = cs.zblocked_helmholtz_apply(
        torch.as_tensor(f), {k: torch.as_tensor(v) for k, v in vecs.items()},
        periodic, None if scale is None
        else tuple(torch.as_tensor(s) for s in scale))
    assert _rel(got, _brute_force(f, vecs, periodic, scale)) <= 1e-13


# ragged against the tiles, tiny, one plane or one row, the sphere's
# velocity and pressure shapes, 256^3, and long thin boxes
PLAN_SHAPES = [(1, 1, 1), (1, 2, 3), (3, 2, 1), (2, 1, 2), (5, 4, 3),
               (13, 9, 11), (7, 33, 65), (1, 1000, 1000), (2000, 3, 3),
               (130, 130, 159), (130, 129, 160), (129, 130, 160),
               (160, 130, 130), (256, 256, 256), (257, 255, 31)]


def _ceil(a, b):
    return -(-a // b)


def _ranges(n, t, g):
    return [(b * t, min(b * t + t, n)) for b in range(g)]


#: resident blocks of a card: one SM with one block, and 132 SMs with 8,
#: 12 and 16 blocks each
SLOTS = (1, 132 * 8, 132 * 12, 132 * 16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_launch_plan_covers_every_cell_once(shape, dtype):
    size = torch.finfo(dtype).bits // 8
    for slots, align in itertools.product(SLOTS, (size, 256)):
        plan = cs.launch_plan(shape, dtype, lambda tile: slots, align)
        tile = tuple(plan[:4])
        # the first choice that fits the field, else the last
        fits = [t for t in cs.TILES[:-1]
                if shape[2] % t[0] == 0 and shape[2] % t[3] == 0
                and align % (t[3] * size) == 0]
        assert tile == (fits[0] if fits else cs.TILES[-1])
        assert cs.plan_error(shape, plan) is None
        g = cs.grid(shape, plan)
        # block (bx, by, bz) takes the product of its ranges along x, y and
        # z: along each axis they must cut [0, n) into non-empty pieces
        for n, t, blocks in zip(shape[::-1], (plan.tx, plan.ty, plan.kz), g):
            ranges = _ranges(n, t, blocks)
            assert ranges[0][0] == 0 and ranges[-1][1] == n
            assert all(lo < hi for lo, hi in ranges)
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        nz = shape[0]
        tiles = g[0] * g[1]
        if tiles > slots:  # a plane's tiles alone overfill the card
            assert plan.kz == nz
            continue
        # one wave: every block resident at once, and as many blocks as
        # that allows: one plane fewer a chunk would overfill the card
        assert tiles * g[2] <= slots
        assert plan.kz == 1 or tiles * _ceil(nz, plan.kz - 1) > slots


def test_launch_plan_takes_a_vector_tile_where_it_fits():
    slots = lambda tile: 1584  # noqa: E731
    assert cs.launch_plan((256, 256, 256), torch.float32, slots, 256)[:4] \
        == cs.TILES[0]
    # the sphere's v: 160 columns, no 64-wide tile without a ragged block
    assert cs.launch_plan((130, 129, 160), torch.float32, slots, 256)[:4] \
        == cs.TILES[1]
    # the sphere's u: an odd x extent takes one column a thread
    for dtype in (torch.float32, torch.float64):
        assert cs.launch_plan((130, 130, 159), dtype, slots, 256)[:4] \
            == cs.TILES[-1]
        # a field one value past an aligned address takes no vector
        assert cs.launch_plan((256, 256, 256), dtype, slots,
                              torch.finfo(dtype).bits // 8)[3] == 1


def test_launch_plan_covers_cells_brute_force():
    # the same, cell by cell, on shapes small enough to enumerate
    for shape in [(5, 4, 3), (13, 9, 11), (7, 33, 65), (3, 2, 70)]:
        for tile in cs.TILES:
            tx, ty = tile[:2]
            for kz in (1, 2, 3, 5, 64):
                plan = cs.Plan(*tile, kz)
                hits = np.zeros(shape, np.int64)
                gx, gy, gz = cs.grid(shape, plan)
                for bx, by, bz in itertools.product(range(gx), range(gy),
                                                    range(gz)):
                    block = hits[bz * kz:bz * kz + kz,
                                 by * ty:by * ty + ty, bx * tx:bx * tx + tx]
                    assert block.size > 0
                    block += 1
                assert (hits == 1).all()


BAD_PLANS = {
    "no instance": ((8, 8, 8), cs.Plan(16, 16, 1, 1, 1)),
    "tile rotated": ((8, 8, 8), cs.Plan(16, 32, 4, 1, 1)),
    "rows a thread": ((8, 8, 8), cs.Plan(32, 8, 3, 1, 1)),
    "columns a thread": ((8, 8, 8), cs.Plan(32, 8, 2, 4, 1)),
    "vector past nx": ((8, 8, 9), cs.Plan(64, 8, 2, 2, 1)),
    "no chunk": ((8, 8, 8), cs.Plan(*cs.TILES[0], 0)),
    "no tile": ((8, 8, 8), cs.Plan(0, 8, 4, 1, 1)),
    "z chunks": ((65536, 1, 1), cs.Plan(*cs.TILES[0], 1)),
    "2^31 cells": ((2048, 1024, 1024), cs.Plan(*cs.TILES[0], 64)),
}


@pytest.mark.parametrize("name", sorted(BAD_PLANS))
def test_plan_error_names_what_the_c_entry_refuses(name):
    shape, plan = BAD_PLANS[name]
    assert cs.plan_error(shape, plan) is not None
    # the plan the wrapper would take for the shape is refused only for
    # 2^31 cells or more, which no plan takes
    plan = cs.launch_plan(shape, torch.float32, lambda tile: 1584, 256)
    assert (cs.plan_error(shape, plan) is None) == (name != "2^31 cells")


def test_plan_error_takes_every_tile_and_chunk():
    for shape in [(1, 1, 1), (8, 8, 8), (65536, 1, 1), (1, 8 * 65535 + 1, 3)]:
        for tile in cs.TILES:
            for kz in (1, 7, 65535, 10 ** 6):
                plan = cs.Plan(*tile, kz)
                fits = -(-shape[0] // kz) <= 65535 and shape[2] % tile[3] == 0
                assert (cs.plan_error(shape, plan) is None) == fits
    # nothing to launch
    assert cs.plan_error((0, 4, 4), cs.Plan(99, 1, 7, 1, 0)) is None


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("use", ["momentum", "poisson"])
def test_cuda_kernel_matches_twin(use, dtype):
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
    # bit for bit: no FMA contraction, the twin's order of operations
    assert torch.equal(got, cs.zblocked_helmholtz_apply_ref(f, *args))


# ragged against every tile, extents 1-3 on each axis, and boxes larger
# than a tile along x and y with a z extent that a chunk does not divide
CARD_SHAPES = [(1, 1, 1), (2, 2, 2), (3, 3, 3), (1, 2, 3), (3, 1, 2),
               (2, 3, 1), (3, 2, 1), (5, 9, 33), (7, 17, 65), (16, 8, 32),
               (33, 20, 70), (40, 37, 129)]


def _card_case(shape, periodic, scaled, dtype, seed):
    rng = np.random.default_rng(seed)
    f = torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                        device="cuda")
    vecs, scale = _vecs_and_scale(rng, shape, scaled)
    vecs = {k: torch.as_tensor(v, dtype=dtype, device="cuda")
            for k, v in vecs.items()}
    if scale is not None:
        scale = tuple(torch.as_tensor(v, dtype=dtype, device="cuda")
                      for v in scale)
    return f, vecs, scale


def _plans(f, scaled):
    """The wrapper's plan, and every tile the field admits (a vector tile:
    nx a multiple of its vector, f aligned to it) with chunks of 1, 2, 3
    planes, one plane short of nz, nz and more than nz."""
    nz = f.shape[0]
    plans = {cs.plan_on_card(f, scaled)}
    for tile in cs.TILES:
        vx = tile[3]
        if f.shape[2] % vx or f.data_ptr() % (vx * f.element_size()):
            continue
        plans |= {cs.Plan(*tile, kz)
                  for kz in (1, 2, 3, max(nz - 1, 1), nz, nz + 5)}
    return sorted(plans)


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_equals_twin_on_every_plan(dtype, scaled):
    _cuda_or_skip()
    for seed, shape in enumerate(CARD_SHAPES):
        for periodic in itertools.product([False, True], repeat=3):
            f, vecs, scale = _card_case(shape, periodic, scaled, dtype, seed)
            want = cs.zblocked_helmholtz_apply_ref(f, vecs, periodic, scale)
            for plan in _plans(f, scaled):
                got = cs.launch(f, vecs, periodic, scale, plan)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (shape, periodic, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_reads_nothing_outside_the_field(dtype, scaled):
    """f is a contiguous slice of a buffer whose planes before and after it
    hold NaN: a read past a wall, or a wrap that goes a plane too far,
    would put NaN in the result."""
    _cuda_or_skip()
    for seed, shape in enumerate([(1, 1, 1), (2, 3, 1), (5, 9, 33),
                                  (33, 20, 70)]):
        for periodic in itertools.product([False, True], repeat=3):
            f, vecs, scale = _card_case(shape, periodic, scaled, dtype, seed)
            nz, ny, nx = shape
            buf = torch.full((nz + 4, ny, nx), float("nan"), dtype=dtype,
                             device="cuda")
            buf[2:-2] = f
            inner = buf[2:-2]
            assert inner.is_contiguous()
            want = cs.zblocked_helmholtz_apply_ref(f, vecs, periodic, scale)
            for plan in _plans(inner, scaled):
                got = cs.launch(inner, vecs, periodic, scale, plan)
                torch.cuda.synchronize()
                assert not bool(got.isnan().any()), (shape, periodic, plan)
                assert torch.equal(got, want), (shape, periodic, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-13)])
def test_cuda_cell_kernel_matches_twin(dtype, tol):
    """The first design (one thread per cell), kept to be timed beside the
    march."""
    _cuda_or_skip()
    for seed, shape in enumerate([(1, 2, 3), (7, 17, 65), (40, 37, 129)]):
        for periodic in itertools.product([False, True], repeat=3):
            for scaled in (False, True):
                f, vecs, scale = _card_case(shape, periodic, scaled, dtype,
                                            seed)
                got = cs.launch_cells(f, vecs, periodic, scale)
                want = cs.zblocked_helmholtz_apply_ref(f, vecs, periodic,
                                                       scale)
                torch.cuda.synchronize()
                assert float((got - want).abs().max()
                             / want.abs().max()) <= tol


@pytest.mark.cuda
def test_cuda_c_entry_refuses_a_misaligned_vector():
    """plan_error cannot see the pointers: a vector tile on a field that
    starts one value past an aligned address is refused by the C entry."""
    _cuda_or_skip()
    f, vecs, scale = _card_case((4, 16, 64), (False,) * 3, False,
                                torch.float32, 0)
    buf = torch.zeros(f.numel() + 1, dtype=f.dtype, device="cuda")
    inner = buf[1:].view(f.shape)
    inner.copy_(f)
    for tile in cs.TILES:
        if tile[3] == 1:
            continue
        plan = cs.Plan(*tile, 1)
        assert cs.plan_error(inner.shape, plan) is None
        with pytest.raises(RuntimeError):
            cs.launch(inner, vecs, (False,) * 3, None, plan)
        assert torch.equal(cs.launch(f, vecs, (False,) * 3, None, plan),
                           cs.zblocked_helmholtz_apply_ref(
                               f, vecs, (False,) * 3, None))


@pytest.mark.cuda
def test_cuda_resident_blocks_fill_one_wave():
    _cuda_or_skip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.float64):
        for scaled in (False, True):
            for tile in cs.TILES:
                slots = cs.resident_blocks("cuda", dtype, scaled, tile)
                assert slots >= sms and slots % sms == 0
            f = torch.zeros((256, 256, 256), dtype=dtype, device="cuda")
            plan = cs.plan_on_card(f, scaled)
            g = cs.grid(f.shape, plan)
            assert tuple(plan[:4]) == cs.TILES[0]
            assert g[0] * g[1] * g[2] <= cs.resident_blocks(
                "cuda", dtype, scaled, plan[:4])


@pytest.mark.cuda
def test_cuda_c_entry_refuses_what_plan_error_names():
    _cuda_or_skip()
    for name, (shape, plan) in sorted(BAD_PLANS.items()):
        if name == "2^31 cells":
            continue  # 8 GB; plan_error's CPU test holds this one
        f, vecs, scale = _card_case(shape, (False,) * 3, True,
                                    torch.float32, 0)
        with pytest.raises(RuntimeError):
            cs.launch(f, vecs, (False,) * 3, scale, plan)
        good = cs.plan_on_card(f, True)
        assert cs.plan_error(shape, good) is None
        got = cs.launch(f, vecs, (False,) * 3, scale, good)
        torch.cuda.synchronize()
        assert torch.equal(got, cs.zblocked_helmholtz_apply_ref(
            f, vecs, (False,) * 3, scale))


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
