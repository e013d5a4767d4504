"""K1, the separable pressure Poisson apply, on 2D [48, 32] and 3D
[12, 10, 32] stretched grids: the port's level-0 factors against
PoissonMG's finest level, the plain twin against the Pallas kernel in
interpret mode and the JAX -A_poisson closure (float64, 1e-12), the
wrapper's CPU dispatch, and the launch plans of the 3D path (the z march
of ``csrc/march.cuh``, shared with K2) and of the 2D path (the row march
of ``csrc/poisson_separable.cu``, ``row_plan``): each grid covers every
cell once at ragged, one-plane (one-row, one-column), short and the main
paths' shapes for every resident-block count of ``SLOTS``, each plan
takes a vector tile where nx and the alignment allow, and ``plan_error``
names what the C entry refuses in 2D and in 3D.  On a card the kernel is
held to its twin bit for bit (in 2D and 3D every plan a shape admits,
ragged bands, tiles and chunks, walls with nonzero face coefficients,
float32 and float64, bfloat16 in 2D, and a field between NaN planes or
rows), the first designs (one thread per cell) too, the wrapper's one
launch a call, and the C entry's refusals to ``plan_error``.

The JAX side is imported inside the tests that use it, so the card-only
tests also run where jax is not installed:

    python -m pytest tests/test_torch_poisson_kernel.py --noconftest -m cuda
"""

import itertools

import numpy as np
import pytest
import torch

from petibm_tpu_torch.linalg.mg import Level, poisson_level0
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


# (nz, ny, nx) of K1's 3D plan: ragged against the tiles in x and in y,
# one plane, fewer planes than a chunk, the sphere's pressure, a
# stretched 256^3 level, and a long thin box
PLAN_SHAPES = {"ragged_x": (9, 17, 45), "ragged_y": (6, 37, 64),
               "one_plane": (1, 40, 96), "short_z": (3, 130, 160),
               "sphere_p": (130, 130, 160), "level_256": (256, 256, 256),
               "thin": (700, 3, 5)}
#: resident blocks of a card: one SM with one block, and 132 SMs with 8,
#: 12 and 16 blocks each
SLOTS = (1, 132 * 8, 132 * 12, 132 * 16)


def _ceil(a, b):
    return -(-a // b)


def _plan(shape, dtype, slots, monkeypatch, offset=0):
    """The wrapper's plan (``separable_plan_on_card``) for a field of
    ``shape`` that starts ``offset`` values past an aligned address, on a
    card holding ``slots`` blocks of every instance."""
    monkeypatch.setattr(cs, "separable_resident_blocks",
                        lambda device, dt, tile: slots)
    n = int(np.prod(shape))
    buf = torch.zeros(n + 64, dtype=dtype)
    start = (-buf.data_ptr() // buf.element_size()) % 64 + offset
    return cs.separable_plan_on_card(buf[start:start + n].view(shape))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_plan_covers_every_cell_once(name, dtype, monkeypatch):
    shape = PLAN_SHAPES[name]
    for slots in SLOTS:
        plan = _plan(shape, dtype, slots, monkeypatch)
        assert cs.plan_error(shape, plan) is None
        g = cs.grid(shape, plan)
        for n, t, blocks in zip(shape[::-1], (plan.tx, plan.ty, plan.kz), g):
            assert 0 < t and (blocks - 1) * t < n <= blocks * t
        tiles = g[0] * g[1]
        if tiles > slots:  # a plane's tiles alone overfill the card
            assert plan.kz == shape[0]
        else:  # one wave, with as many blocks as that allows
            assert tiles * g[2] <= slots
            assert plan.kz == 1 or tiles * _ceil(shape[0], plan.kz - 1) > slots
        if np.prod(shape) > 4e6:
            continue
        # cell by cell: every block non-empty, every cell in one block
        hits = np.zeros(shape, np.uint8)
        for bx, by, bz in itertools.product(*map(range, g)):
            block = hits[bz * plan.kz:(bz + 1) * plan.kz,
                         by * plan.ty:(by + 1) * plan.ty,
                         bx * plan.tx:(bx + 1) * plan.tx]
            assert block.size > 0
            block += 1
        assert (hits == 1).all()


# (shape, dtype, the field's offset in values from an aligned address,
# the tile the plan takes)
VECTOR_CASES = {
    "256_vector": ((256, 256, 256), torch.float32, 0, cs.TILES[0]),
    "sphere_p": ((130, 130, 160), torch.float32, 0, (32, 16, 4, 2)),
    "sphere_p_f64": ((130, 130, 160), torch.float64, 0, (32, 16, 4, 2)),
    "odd_nx": ((130, 130, 159), torch.float32, 0, cs.TILES[-1]),
    "misaligned": ((130, 130, 160), torch.float32, 1, cs.TILES[-1]),
    "misaligned_f64": ((64, 64, 64), torch.float64, 1, cs.TILES[-1]),
    "ragged_64": ((8, 8, 96), torch.float32, 0, (32, 16, 4, 2)),
}


@pytest.mark.parametrize("name", sorted(VECTOR_CASES))
def test_plan_takes_a_vector_tile_where_it_fits(name, monkeypatch):
    shape, dtype, offset, tile = VECTOR_CASES[name]
    plan = _plan(shape, dtype, 1584, monkeypatch, offset)
    assert tuple(plan[:4]) == tile
    assert cs.plan_error(shape, plan) is None


# (shape, plan) that the C entry refuses, and the words of plan_error's
# reason
K1_BAD_PLANS = {
    "no instance": ((8, 8, 8), cs.Plan(16, 16, 1, 1, 1), "instance"),
    "vector past nx": ((8, 8, 45), cs.Plan(32, 16, 4, 2, 1), "vector"),
    "no chunk": ((8, 8, 8), cs.Plan(32, 16, 4, 2, 0), "chunks"),
    "z chunks": ((65536, 1, 1), cs.Plan(32, 16, 4, 1, 1), "chunks"),
    "2^31 cells": ((2048, 1024, 1024), cs.Plan(*cs.TILES[0], 64), "2^31"),
    "negative": ((-1, 8, 8), cs.Plan(*cs.TILES[0], 1), "negative"),
}


@pytest.mark.parametrize("name", sorted(K1_BAD_PLANS))
def test_plan_error_names_what_the_c_entry_refuses(name):
    shape, plan, words = K1_BAD_PLANS[name]
    assert words in cs.plan_error(shape, plan)
    if min(shape) < 0:
        return
    # the plan the wrapper would take for the shape is refused only for
    # 2^31 cells or more, which no plan takes
    good = cs.launch_plan(shape, torch.float32, lambda tile: 1584, 256)
    assert (cs.plan_error(shape, good) is None) == (name != "2^31 cells")


# (ny, nx) of K1's 2D plan: bands ragged against both row tiles, one row,
# one column, and the flagship's and the oscillating cylinder's pressure
ROW_SHAPES = {"ragged_band": (17, 45), "ragged_wide": (37, 300),
              "one_row": (1, 96), "one_column": (40, 1), "32x32": (32, 32),
              "450x450": (450, 450), "512x512": (512, 512)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("name", sorted(ROW_SHAPES))
def test_row_plan_covers_every_cell_once(name, dtype, monkeypatch):
    shape = ROW_SHAPES[name]
    ny, nx = shape
    for slots in SLOTS:
        plan = _plan(shape, dtype, slots, monkeypatch)
        assert tuple(plan[:4]) in cs.ROW_TILES
        assert cs.plan_error(shape, plan) is None
        bands, rows, chunks = cs.grid(shape, plan)
        assert rows == 1
        assert (bands - 1) * plan.tx < nx <= bands * plan.tx
        assert (chunks - 1) * plan.kz < ny <= chunks * plan.kz
        # chunks of whole groups of the tile's ry rows
        groups, per_chunk = _ceil(ny, plan.ry), plan.kz // plan.ry
        assert plan.kz % plan.ry == 0
        if bands > slots:  # a row's bands alone overfill the card
            assert per_chunk == groups
        else:  # one wave, with as many blocks as that allows
            assert bands * chunks <= slots
            assert (per_chunk == 1
                    or bands * _ceil(groups, per_chunk - 1) > slots)
        # cell by cell: every block non-empty, every cell in one block
        hits = np.zeros(shape, np.uint8)
        for bx, by in itertools.product(range(bands), range(chunks)):
            block = hits[by * plan.kz:(by + 1) * plan.kz,
                         bx * plan.tx:(bx + 1) * plan.tx]
            assert block.size > 0
            block += 1
        assert (hits == 1).all()


# (shape, dtype, the field's offset in values from an aligned address,
# the row tile the plan takes)
ROW_VECTOR_CASES = {
    "450_vector": ((450, 450), torch.float32, 0, cs.ROW_TILES[0]),
    "450_f64": ((450, 450), torch.float64, 0, cs.ROW_TILES[0]),
    "450_bf16": ((450, 450), torch.bfloat16, 0, cs.ROW_TILES[0]),
    "odd_nx": ((450, 451), torch.float32, 0, cs.ROW_TILES[-1]),
    "misaligned": ((512, 512), torch.float32, 1, cs.ROW_TILES[-1]),
    "misaligned_bf16": ((450, 450), torch.bfloat16, 1, cs.ROW_TILES[-1]),
    "one_column": ((40, 1), torch.float64, 0, cs.ROW_TILES[-1]),
}


@pytest.mark.parametrize("name", sorted(ROW_VECTOR_CASES))
def test_row_plan_takes_a_vector_where_it_fits(name, monkeypatch):
    shape, dtype, offset, tile = ROW_VECTOR_CASES[name]
    plan = _plan(shape, dtype, 2112, monkeypatch, offset)
    assert tuple(plan[:4]) == tile
    assert cs.plan_error(shape, plan) is None


# (2D shape, plan) that the C entry refuses, and the words of plan_error's
# reason
K1_BAD_ROW_PLANS = {
    "a z-march tile": ((8, 8), cs.Plan(*cs.TILES[0], 1), "instance"),
    "no row instance": ((8, 64), cs.Plan(64, 1, 1, 2, 1), "instance"),
    "vector past nx": ((8, 45), cs.Plan(*cs.ROW_TILES[0], 1), "vector"),
    "no chunk": ((8, 8), cs.Plan(*cs.ROW_TILES[1], 0), "chunks"),
    "row chunks": ((65536, 3), cs.Plan(*cs.ROW_TILES[1], 1), "chunks"),
    "2^31 cells": ((65536, 32768), cs.Plan(*cs.ROW_TILES[0], 2), "2^31"),
    "negative": ((8, -1), cs.Plan(*cs.ROW_TILES[1], 1), "negative"),
}


@pytest.mark.parametrize("name", sorted(K1_BAD_ROW_PLANS))
def test_plan_error_names_what_the_c_entry_refuses_in_2d(name):
    shape, plan, words = K1_BAD_ROW_PLANS[name]
    assert words in cs.plan_error(shape, plan)
    if min(shape) < 0:
        return
    # the plan the wrapper would take for the shape is refused only for
    # 2^31 cells or more, which no plan takes
    good = cs.row_plan(shape, torch.float32, lambda tile: 2112, 256)
    assert (cs.plan_error(shape, good) is None) == (name != "2^31 cells")


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_cuda_kernel_matches_twin(name, dtype):
    _cuda_or_skip()
    ns = SHAPES[name]
    level = poisson_level0(_widths(ns), [False] * len(ns), dtype=dtype,
                           device="cuda", scale=0.01)
    phi = torch.as_tensor(_phi(level.shape), dtype=dtype, device="cuda")
    before = cs.poisson_apply_separable.launches
    got = cs.poisson_apply_separable(phi, level)
    torch.cuda.synchronize()
    assert cs.poisson_apply_separable.launches == before + 1
    # bit for bit: no FMA contraction, the twin's order of operations
    assert torch.equal(got, cs.poisson_apply_separable_ref(phi, level))


# ragged against every tile, extents 1-3 on each axis, and boxes larger
# than a tile along x and y with a z extent that a chunk does not divide
CARD_SHAPES = [(1, 1, 1), (2, 2, 2), (3, 3, 3), (1, 2, 3), (3, 1, 2),
               (2, 3, 1), (3, 2, 1), (5, 9, 33), (7, 17, 65), (16, 8, 32),
               (33, 20, 70), (40, 37, 129), (13, 130, 160)]


def _random_level(shape, dtype, seed):
    """A non-periodic level of ``shape`` (z, y, x) with random positive
    factors, the face coefficients at the walls nonzero too (the twin's
    neighbours past a wall are 0 whatever they multiply)."""
    rng = np.random.default_rng(seed)
    ns = shape[::-1]
    c1d = [torch.as_tensor(rng.uniform(0.5, 2.0, n + 1), dtype=dtype,
                           device="cuda") for n in ns]
    w1d = [torch.as_tensor(rng.uniform(0.5, 2.0, n), dtype=dtype,
                           device="cuda") for n in ns]
    phi = torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                          device="cuda")
    return Level(tuple(shape), c1d, w1d, [False] * len(shape)), phi


def _plans(phi):
    """The wrapper's plan, and every tile the field admits (a vector tile:
    nx a multiple of its vector, phi aligned to it) with chunks of 1, 2, 3
    planes, one plane short of nz, nz and more than nz."""
    nz = phi.shape[0]
    plans = {cs.separable_plan_on_card(phi)}
    for tile in cs.TILES:
        vx = tile[3]
        if phi.shape[2] % vx or phi.data_ptr() % (vx * phi.element_size()):
            continue
        plans |= {cs.Plan(*tile, kz)
                  for kz in (1, 2, 3, max(nz - 1, 1), nz, nz + 5)}
    return sorted(plans)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_march_equals_twin_on_every_plan(dtype):
    _cuda_or_skip()
    for seed, shape in enumerate(CARD_SHAPES):
        level, phi = _random_level(shape, dtype, seed)
        want = cs.poisson_apply_separable_ref(phi, level)
        for plan in _plans(phi):
            got = cs.separable_launch(phi, level, plan)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (shape, plan)


#: 2D shapes on the card: those of test_cuda_2d_kernel_equals_twin, then
#: bands ragged against both row tiles, one row, one column and 512^2
CARD_ROW_SHAPES = [(1, 1), (2, 3), (3, 2), (37, 129), (450, 450), (1, 130),
                   (130, 1), (5, 64), (9, 450), (17, 257), (3, 258),
                   (512, 512)]


def _row_plans(phi):
    """The wrapper's plan, and every row tile the field admits (a vector
    tile: nx a multiple of its vector, phi aligned to it) with chunks of
    1, 2, 3 rows, one row short of ny, ny and more than ny."""
    ny = phi.shape[0]
    plans = {cs.separable_plan_on_card(phi)}
    for tile in cs.ROW_TILES:
        vx = tile[3]
        if phi.shape[1] % vx or phi.data_ptr() % (vx * phi.element_size()):
            continue
        plans |= {cs.Plan(*tile, ky)
                  for ky in (1, 2, 3, max(ny - 1, 1), ny, ny + 5)}
    return sorted(plans)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_cuda_row_march_equals_twin_on_every_plan(dtype):
    _cuda_or_skip()
    for seed, shape in enumerate(CARD_ROW_SHAPES):
        level, phi = _random_level(shape, dtype, seed)
        want = cs.poisson_apply_separable_ref(phi, level)
        for plan in _row_plans(phi):
            got = cs.separable_launch(phi, level, plan)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (shape, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_cuda_row_march_reads_nothing_outside_the_field(dtype):
    """phi is a contiguous slice of a buffer whose rows before and after
    it hold NaN: a read past a wall would put NaN in the result."""
    _cuda_or_skip()
    for seed, shape in enumerate([(1, 1), (3, 2), (1, 130), (130, 1),
                                  (17, 257), (450, 450)]):
        level, phi = _random_level(shape, dtype, seed)
        ny, nx = shape
        buf = torch.full((ny + 4, nx), float("nan"), dtype=dtype,
                         device="cuda")
        buf[2:-2] = phi
        inner = buf[2:-2]
        assert inner.is_contiguous()
        want = cs.poisson_apply_separable_ref(phi, level)
        for plan in _row_plans(inner):
            got = cs.separable_launch(inner, level, plan)
            torch.cuda.synchronize()
            assert not bool(got.isnan().any()), (shape, plan)
            assert torch.equal(got, want), (shape, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_cuda_2d_wrapper_counts_one_launch_of_the_row_march(dtype):
    """The wrapper launches the row march with ``row_plan``'s plan (a row
    tile, one wave of the card's resident blocks at 450^2), one launch in
    its counter a call."""
    _cuda_or_skip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for tile in cs.ROW_TILES:
        slots = cs.separable_resident_blocks("cuda", dtype, tile)
        assert slots >= sms and slots % sms == 0
    level, phi = _random_level((450, 450), dtype, 7)
    plan = cs.separable_plan_on_card(phi)
    assert tuple(plan[:4]) == cs.ROW_TILES[0]
    bands, _, chunks = cs.grid(phi.shape, plan)
    assert bands * chunks <= cs.separable_resident_blocks("cuda", dtype,
                                                          plan[:4])
    before = cs.poisson_apply_separable.launches
    got = cs.poisson_apply_separable(phi, level)
    torch.cuda.synchronize()
    assert cs.poisson_apply_separable.launches == before + 1
    assert torch.equal(got, cs.separable_launch(phi, level, plan))
    assert torch.equal(got, cs.poisson_apply_separable_ref(phi, level))


@pytest.mark.cuda
def test_cuda_c_entry_refuses_what_plan_error_names_in_2d():
    _cuda_or_skip()
    for name, (shape, plan, words) in sorted(K1_BAD_ROW_PLANS.items()):
        if name in ("2^31 cells", "negative"):
            continue  # 8 GB, and no such tensor; the CPU test holds these
        level, phi = _random_level(shape, torch.float32, 0)
        with pytest.raises(RuntimeError, match=words):
            cs.separable_launch(phi, level, plan)
    # plan_error cannot see the pointers: a vector tile on a field that
    # starts one value past an aligned address is refused by the C entry
    level, phi = _random_level((16, 64), torch.float32, 1)
    buf = torch.zeros(phi.numel() + 1, dtype=phi.dtype, device="cuda")
    inner = buf[1:].view(phi.shape)
    inner.copy_(phi)
    plan = cs.Plan(*cs.ROW_TILES[0], 1)
    assert cs.plan_error(inner.shape, plan) is None
    with pytest.raises(RuntimeError):
        cs.separable_launch(inner, level, plan)
    assert tuple(cs.separable_plan_on_card(inner)[:4]) == cs.ROW_TILES[-1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_2d_kernel_equals_twin(dtype):
    _cuda_or_skip()
    for seed, shape in enumerate([(1, 1), (2, 3), (3, 2), (37, 129),
                                  (450, 450)]):
        level, phi = _random_level(shape, dtype, seed)
        got = cs.poisson_apply_separable(phi, level)
        torch.cuda.synchronize()
        assert torch.equal(got, cs.poisson_apply_separable_ref(phi, level))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_march_reads_nothing_outside_the_field(dtype):
    """phi is a contiguous slice of a buffer whose planes before and after
    it hold NaN: a read past a wall would put NaN in the result."""
    _cuda_or_skip()
    for seed, shape in enumerate([(1, 1, 1), (2, 3, 1), (5, 9, 33),
                                  (33, 20, 70), (13, 130, 160)]):
        level, phi = _random_level(shape, dtype, seed)
        nz, ny, nx = shape
        buf = torch.full((nz + 4, ny, nx), float("nan"), dtype=dtype,
                         device="cuda")
        buf[2:-2] = phi
        inner = buf[2:-2]
        assert inner.is_contiguous()
        want = cs.poisson_apply_separable_ref(phi, level)
        for plan in _plans(inner):
            got = cs.separable_launch(inner, level, plan)
            torch.cuda.synchronize()
            assert not bool(got.isnan().any()), (shape, plan)
            assert torch.equal(got, want), (shape, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_cuda_cell_kernel_matches_twin(dtype):
    """The first designs (one thread per cell), kept to be timed beside
    the marches, built without FMA contraction as the marches are."""
    _cuda_or_skip()
    for seed, shape in enumerate([(1, 2, 3), (7, 17, 65), (40, 37, 129),
                                  (37, 129)]):
        level, phi = _random_level(shape, dtype, seed)
        got = cs.separable_launch_cells(phi, level)
        torch.cuda.synchronize()
        assert torch.equal(got, cs.poisson_apply_separable_ref(phi, level))


@pytest.mark.cuda
def test_cuda_c_entry_refuses_what_plan_error_names():
    _cuda_or_skip()
    for name, (shape, plan, words) in sorted(K1_BAD_PLANS.items()):
        if name in ("2^31 cells", "negative"):
            continue  # 8 GB, and no such tensor; the CPU test holds these
        level, phi = _random_level(shape, torch.float32, 0)
        with pytest.raises(RuntimeError, match=words):
            cs.separable_launch(phi, level, plan)
        good = cs.separable_plan_on_card(phi)
        assert cs.plan_error(shape, good) is None
        got = cs.separable_launch(phi, level, good)
        torch.cuda.synchronize()
        assert torch.equal(got, cs.poisson_apply_separable_ref(phi, level))
    # plan_error cannot see the pointers: a vector tile on a field that
    # starts one value past an aligned address is refused by the C entry
    level, phi = _random_level((4, 16, 64), torch.float32, 1)
    buf = torch.zeros(phi.numel() + 1, dtype=phi.dtype, device="cuda")
    inner = buf[1:].view(phi.shape)
    inner.copy_(phi)
    plan = cs.Plan(32, 16, 4, 2, 1)
    assert cs.plan_error(inner.shape, plan) is None
    with pytest.raises(RuntimeError):
        cs.separable_launch(inner, level, plan)


@pytest.mark.cuda
def test_cuda_resident_blocks_fill_one_wave():
    _cuda_or_skip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.float64):
        for tile in cs.TILES:
            slots = cs.separable_resident_blocks("cuda", dtype, tile)
            assert slots >= sms and slots % sms == 0
        phi = torch.zeros((130, 130, 160), dtype=dtype, device="cuda")
        plan = cs.separable_plan_on_card(phi)
        g = cs.grid(phi.shape, plan)
        assert tuple(plan[:4]) == (32, 16, 4, 2)
        assert g[0] * g[1] * g[2] <= cs.separable_resident_blocks(
            "cuda", dtype, plan[:4])


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
