"""K3, the 3D divergence-form convection (one launch forms the three
velocity components), through ``convection3d_apply`` and
``make_cuda_convection``.

On the CPU the wrapper runs its plain twin per component.  The twin is
held, in float64, to 1e-12 of each component's maximum against the
Pallas kernel in interpret mode (``make_pallas_convection``; each test
asserts that the JAX factory built its kernel), the JAX convection
closure and the port's own ``operators/convection.py`` closure, on
non-cubic stretched grids with mixed periodic and wall axes (the mesh of
tests/test_pallas.py among them).  The CPU tests also hold the kernel's
union box and per-component masks (the twin over the union box, with 0
wherever a value lies outside an array, equals the twin on each
component's cells bit for bit), ``convection_launch_plan`` (its grid
covers the union box once, one wave of the card's blocks) and
``convection_plan_error``, the C entry's refusals.  On a card the kernel
is held to the twin bit for bit (float32 and float64; the meshes above,
ragged tiles, odd x extents, one-plane chunks, the sphere's shapes, every
tile instance, arrays between NaN planes) and the C entry's refusals to
``convection_plan_error``:

    python -m pytest tests/test_torch_convection_kernel.py --noconftest -m cuda
"""

import itertools

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


def _ext(bcs, q, state):
    return [bcs.extend(q[k], e, state) for e, k in enumerate("uvw")]


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
    # the wrapper: the three components from one call
    got = dict(zip("uvw", cs.convection3d_apply(_ext(bcs, tq, tstate),
                                                port.inv_dl)))
    closure = port(tq, tstate)
    want_pallas = pallas(jq, jstate)
    want_jax = jconv(jmesh, jbcs, jnp.float64)(jq, jstate)
    want_port = make_convection(mesh, bcs, dtype=torch.float64,
                                device="cpu")(tq, tstate)
    for key in "uvw":
        assert torch.equal(closure[key], got[key])
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
    ext = _ext(bcs, q, state)
    for c, key in enumerate("uvw"):
        assert got[key].dtype == torch.float32
        assert torch.equal(got[key], cs.convection3d_apply_ref(
            ext, c, conv.inv_dl[c]))


@pytest.mark.parametrize("name", sorted(MESHES))
def test_union_box_and_masks(name):
    """What the kernel does over the union box: every array read through
    a window of the box, each value outside an array a literal 0, and
    component c written only inside its own shape.  The twin run that way
    (each extended array zero-padded to the box plus 2) equals the twin
    on each component's cells, bit for bit: the zeros feed only the cells
    a component does not write."""
    mesh, bcs, conv = _port(name)
    q = {k: torch.as_tensor(v) for k, v in _random_q(mesh, 8).items()}
    ext = _ext(bcs, q, bcs.init_state(q))
    shapes = [tuple(q[k].shape) for k in "uvw"]
    union = cs.convection_union([e.shape for e in ext])
    assert union == tuple(max(s[ax] for s in shapes) for ax in range(3))
    padded = []
    for e in ext:
        box = torch.zeros(tuple(n + 2 for n in union), dtype=e.dtype)
        box[tuple(slice(0, n) for n in e.shape)] = e
        padded.append(box)
    short = 0
    for c in range(3):
        iv = tuple(torch.cat([v, torch.zeros(union[2 - d] - v.shape[0],
                                             dtype=v.dtype)])
                   for d, v in enumerate(conv.inv_dl[c]))
        over_box = cs.convection3d_apply_ref(padded, c, iv)
        assert tuple(over_box.shape) == union
        want = cs.convection3d_apply_ref(ext, c, conv.inv_dl[c])
        mask = tuple(slice(0, n) for n in shapes[c])
        assert torch.equal(over_box[mask], want)
        short += shapes[c] != union
    # a component is one shorter on its own axis past a wall
    walls = [not p for p in mesh.periodic]
    assert short == sum(walls)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    mesh, bcs, conv = _port("test_pallas")
    q = {k: torch.as_tensor(v) for k, v in _random_q(mesh, 4).items()}
    ext = _ext(bcs, q, bcs.init_state(q))
    iv = conv.inv_dl
    with pytest.raises(ValueError):  # two arrays
        cs.convection3d_apply(ext[:2], iv)
    with pytest.raises(ValueError):  # 2D arrays
        cs.convection3d_apply([e[0] for e in ext], iv)
    with pytest.raises(ValueError):  # one component's 1/dl for all three
        cs.convection3d_apply(ext, [iv[0]] * 3)
    with pytest.raises(ValueError):  # one component's 1/dl, not three
        cs.convection3d_apply(ext, iv[0])
    with pytest.raises(ValueError):  # an advecting array cut too short
        cs.convection3d_apply([ext[0], ext[1][:, :-2, :], ext[2]], iv)
    with pytest.raises(ValueError):  # an array with no interior
        cs.convection3d_apply([ext[0][:2], ext[1], ext[2]], iv)
    with pytest.raises(ValueError):  # mixed dtypes
        cs.convection3d_apply([ext[0], ext[1].float(), ext[2]], iv)
    with pytest.raises(ValueError):  # 1/dl in another dtype
        cs.convection3d_apply(ext, [tuple(v.float() for v in c) for c in iv])
    with pytest.raises(TypeError):
        cs.convection3d_apply([e.half() for e in ext],
                              [tuple(v.half() for v in c) for c in iv])


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


def _ext_shapes(cells, periodic):
    """The three extended shapes of a (nz, ny, nx) cell box with periodic
    flags (z, y, x): component c is one shorter along its own axis (array
    axis 2 - c) past a wall, then 2 more on every axis."""
    return [tuple(n - (ax == 2 - c and not periodic[ax]) + 2
                  for ax, n in enumerate(cells)) for c in range(3)]


def _combos(cells):
    """The periodic flags (z, y, x) a cell box takes: a wall needs two
    cells along its axis (one face inside)."""
    return [p for p in itertools.product([False, True], repeat=3)
            if all(per or n > 1 for per, n in zip(p, cells))]


# ragged against the tile, odd x extents, one plane, one row, the sphere
# (walls on every axis), 256^3 (periodic) and long thin boxes
PLAN_CELLS = [(1, 1, 1), (1, 2, 3), (2, 1, 2), (5, 4, 3), (13, 9, 11),
              (7, 17, 33), (1, 40, 70), (3, 1, 65), (2000, 3, 3),
              (130, 130, 160), (256, 256, 256), (257, 255, 31)]
#: resident blocks of a card: one SM with one block, and 132 SMs with 2,
#: 4 and 8 blocks each
SLOTS = (1, 132 * 2, 132 * 4, 132 * 8)


def _ceil(a, b):
    return -(-a // b)


@pytest.mark.parametrize("cells", PLAN_CELLS)
def test_launch_plan_covers_the_union_box_once(cells):
    for periodic, dtype in itertools.product(
            _combos(cells), (torch.float32, torch.float64)):
        shapes = _ext_shapes(cells, periodic)
        union = cs.convection_union(shapes)
        assert union == cells
        for slots in SLOTS:
            plan = cs.convection_launch_plan(shapes, dtype,
                                             lambda tile: slots)
            # each dtype its tile
            assert tuple(plan[:4]) == cs.CONVECTION_TILES[
                dtype == torch.float64]
            assert cs.convection_plan_error(shapes, plan) is None
            g = cs.grid(union, plan)
            # along each axis the blocks cut [0, n) into non-empty pieces
            for n, t, blocks in zip(union[::-1],
                                    (plan.tx, plan.ty, plan.kz), g):
                assert (blocks - 1) * t < n <= blocks * t
            tiles = g[0] * g[1]
            if tiles > slots:  # a plane's tiles alone overfill the card
                assert plan.kz == union[0]
                continue
            # one wave, and one plane fewer a chunk would overfill it
            assert tiles * g[2] <= slots
            assert plan.kz == 1 or tiles * _ceil(union[0], plan.kz - 1) > slots


def test_launch_plan_cuts_chunk_edges():
    # the last chunk is shorter; chunks of one plane where the card holds
    # a block per tile per plane
    shapes = _ext_shapes((130, 130, 160), (False,) * 3)
    for dtype, ty in ((torch.float32, 16), (torch.float64, 8)):
        tiles = _ceil(160, 32) * _ceil(130, ty)

        def plan(slots):
            return cs.convection_launch_plan(shapes, dtype, lambda t: slots)

        assert plan(tiles * 130).kz == 1
        assert plan(tiles * 129).kz == 2
        assert plan(tiles * 3).kz == 44
        assert cs.grid((130, 130, 160), plan(tiles * 3))[2] == 3


BAD = {
    # name: (extended shapes, plan); the sphere's shapes unless said
    "no instance": (None, cs.Plan(16, 16, 1, 1, 1)),
    "a vector tile": (None, cs.Plan(32, 16, 4, 2, 8)),
    "rows a thread": (None, cs.Plan(32, 16, 3, 1, 8)),
    "no chunk": (None, cs.Plan(*cs.CONVECTION_TILES[0], 0)),
    "z chunks": (_ext_shapes((65536, 1, 1), (True,) * 3),
                 cs.Plan(*cs.CONVECTION_TILES[0], 1)),
    "no interior": ([(2, 5, 5), (4, 5, 5), (4, 5, 5)],
                    cs.Plan(*cs.CONVECTION_TILES[0], 1)),
    # the 3^3 walled box is [(5, 5, 4), (5, 4, 5), (4, 5, 5)]
    "ext v too short for u": (
        [(5, 5, 4), (5, 3, 5), (4, 5, 5)], cs.Plan(*cs.CONVECTION_TILES[0], 1)),
    "ext u too short for v": (
        [(5, 5, 3), (5, 4, 5), (4, 5, 5)], cs.Plan(*cs.CONVECTION_TILES[0], 1)),
    "2^31 values": (_ext_shapes((2046, 1022, 1024), (True,) * 3),
                    cs.Plan(*cs.CONVECTION_TILES[0], 64)),
    "2^31 cells in the union": (
        [(3, 3, 2050), (3, 2050, 3), (2050, 3, 3)],
        cs.Plan(*cs.CONVECTION_TILES[0], 64)),
}
SPHERE = _ext_shapes((130, 130, 160), (False,) * 3)


@pytest.mark.parametrize("name", sorted(BAD))
def test_plan_error_names_what_the_c_entry_refuses(name):
    shapes, plan = BAD[name]
    shapes = SPHERE if shapes is None else shapes
    assert cs.convection_plan_error(shapes, plan) is not None
    # the wrapper's own plan is refused only where the arrays are
    good = cs.convection_launch_plan(shapes, torch.float32,
                                     lambda tile: 1056) \
        if min(map(min, shapes)) >= 3 else None
    refused = cs.convection_shape_error(shapes) is not None
    assert refused == (name in ("no interior", "ext v too short for u",
                                "ext u too short for v", "2^31 values",
                                "2^31 cells in the union"))
    if good is not None:
        assert (cs.convection_plan_error(shapes, good) is None) != refused


def test_plan_error_takes_every_tile_and_chunk():
    for cells in [(1, 1, 1), (8, 8, 8), (65535, 1, 2), (65536, 1, 1)]:
        shapes = _ext_shapes(cells, (True,) * 3)
        for tile, kz in itertools.product(cs.CONVECTION_TILES,
                                          (1, 7, 65535, 10 ** 6)):
            plan = cs.Plan(*tile, kz)
            fits = _ceil(cells[0], kz) <= 65535
            assert (cs.convection_plan_error(shapes, plan) is None) == fits


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _card_case(cells, periodic, dtype, seed):
    """Random extended arrays of a cell box (numpy seed) and positive 1/dl
    vectors, on the card."""
    rng = np.random.default_rng(seed)
    ext = [torch.as_tensor(rng.standard_normal(s), dtype=dtype,
                           device="cuda")
           for s in _ext_shapes(cells, periodic)]
    inv_dl = [tuple(torch.as_tensor(rng.uniform(0.5, 2.0, e.shape[2 - d] - 2),
                                    dtype=dtype, device="cuda")
                    for d in range(3)) for e in ext]
    return ext, inv_dl


def _twin(ext, inv_dl):
    return [cs.convection3d_apply_ref(ext, c, inv_dl[c]) for c in range(3)]


def _plans(ext):
    """The wrapper's plan and, with every tile instance, chunks of one
    plane, of 3 and of the whole box."""
    shapes = [tuple(e.shape) for e in ext]
    nz = cs.convection_union(shapes)[0]
    plans = [cs.convection_plan_on_card(ext)]
    plans += [cs.Plan(*tile, kz) for tile in cs.CONVECTION_TILES
              for kz in (1, 3, nz)]
    return list(dict.fromkeys(plans))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["test_pallas", "walled_stretched"])
def test_cuda_kernel_matches_twin(name, dtype):
    _cuda_or_skip()
    mesh, bcs, conv = _port(name, dtype=dtype, device="cuda")
    q = {k: torch.as_tensor(v, dtype=dtype, device="cuda")
         for k, v in _random_q(mesh, 5).items()}
    state = bcs.init_state(q)
    before = cs.convection3d_apply.launches
    got = conv(q, state)
    torch.cuda.synchronize()
    assert cs.convection3d_apply.launches == before + 1
    ext = _ext(bcs, q, state)
    for c, key in enumerate("uvw"):
        assert torch.equal(got[key], cs.convection3d_apply_ref(
            ext, c, conv.inv_dl[c]))


# ragged tiles, odd x extents, one plane, one row, and the sphere's shapes
CARD_CELLS = [(1, 1, 1), (1, 2, 3), (2, 1, 2), (3, 17, 33), (5, 16, 32),
              (9, 31, 63), (1, 40, 70), (4, 1, 65), (130, 130, 160)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_equals_twin_on_every_plan(dtype):
    _cuda_or_skip()
    for seed, cells in enumerate(CARD_CELLS):
        combos = _combos(cells) if max(cells) < 100 else [(False,) * 3]
        for periodic in combos:
            ext, inv_dl = _card_case(cells, periodic, dtype, seed)
            want = _twin(ext, inv_dl)
            for plan in _plans(ext):
                got = cs.convection_launch(ext, inv_dl, plan)
                torch.cuda.synchronize()
                for c in range(3):
                    assert torch.equal(got[c], want[c]), (cells, periodic,
                                                          plan, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_reads_nothing_outside_the_arrays(dtype):
    """Each extended array is a contiguous slice of a buffer whose planes
    before and after it hold NaN: a read past an array's end (a shorter
    component's row, column or plane in the union box) would put NaN in
    a result."""
    _cuda_or_skip()
    for seed, cells in enumerate([(1, 1, 1), (2, 3, 1), (5, 9, 33),
                                  (33, 20, 70)]):
        for periodic in _combos(cells):
            ext, inv_dl = _card_case(cells, periodic, dtype, seed)
            inner = []
            for e in ext:
                buf = torch.full((e.shape[0] + 4, *e.shape[1:]), float("nan"),
                                 dtype=dtype, device="cuda")
                buf[2:-2] = e
                inner.append(buf[2:-2])
                assert inner[-1].is_contiguous()
            want = _twin(ext, inv_dl)
            for plan in _plans(inner):
                got = cs.convection_launch(inner, inv_dl, plan)
                torch.cuda.synchronize()
                for c in range(3):
                    assert not bool(got[c].isnan().any()), (cells, plan)
                    assert torch.equal(got[c], want[c]), (cells, periodic,
                                                          plan, c)


@pytest.mark.cuda
def test_cuda_resident_blocks_fill_one_wave():
    _cuda_or_skip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.float64):
        for tile in cs.CONVECTION_TILES:
            slots = cs.convection_resident_blocks("cuda", dtype, tile)
            assert slots >= sms and slots % sms == 0
        ext, _ = _card_case((256, 256, 256), (True,) * 3, dtype, 0)
        plan = cs.convection_plan_on_card(ext)
        assert tuple(plan[:4]) == cs.CONVECTION_TILES[dtype == torch.float64]
        g = cs.grid((256, 256, 256), plan)
        assert g[0] * g[1] * g[2] <= cs.convection_resident_blocks(
            "cuda", dtype, plan[:4])


@pytest.mark.cuda
def test_cuda_c_entry_refuses_what_plan_error_names():
    _cuda_or_skip()
    for name, (shapes, plan) in sorted(BAD.items()):
        if name.startswith("2^31"):
            continue  # 8 GB and more; the CPU test holds these
        shapes = SPHERE if shapes is None else shapes
        rng = np.random.default_rng(0)
        ext = [torch.as_tensor(rng.standard_normal(s), dtype=torch.float32,
                               device="cuda") for s in shapes]
        inv_dl = [tuple(torch.ones(max(e.shape[2 - d] - 2, 1), device="cuda")
                        for d in range(3)) for e in ext]
        with pytest.raises(RuntimeError):
            cs.convection_launch(ext, inv_dl, plan)
        if cs.convection_shape_error(shapes) is None:
            got = cs.convection_launch(ext, inv_dl,
                                       cs.convection_plan_on_card(ext))
            torch.cuda.synchronize()
            for c, want in enumerate(_twin(ext, inv_dl)):
                assert torch.equal(got[c], want)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    _cuda_or_skip()
    mesh, bcs, conv = _port("periodic", dtype=torch.float32, device="cuda")
    q = {k: torch.as_tensor(v, dtype=torch.float32, device="cuda")
         for k, v in _random_q(mesh, 6).items()}
    ext = _ext(bcs, q, bcs.init_state(q))
    strided = torch.zeros(tuple(2 * s for s in ext[0].shape),
                          device="cuda")[::2, ::2, ::2]
    assert not strided.is_contiguous()
    with pytest.raises(ValueError):
        cs.convection3d_apply([strided, ext[1], ext[2]], conv.inv_dl)
    with pytest.raises(ValueError):  # 1/dl on another device
        cs.convection3d_apply(ext, [tuple(v.cpu() for v in c)
                                    for c in conv.inv_dl])
    with pytest.raises(ValueError):  # arrays on two devices
        cs.convection3d_apply([ext[0].cpu(), ext[1], ext[2]], conv.inv_dl)
