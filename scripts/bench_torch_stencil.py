"""K1's 3D path and K2, the two users of the z march (``csrc/march.cuh``,
the 3D 7-point stencil that marches a tile of the xy plane up a chunk of
z planes), and K3, the convection's own z march of three arrays
(``csrc/convection3d.cu``), at the main paths' shapes: the launch plan
against other tiles and chunk lengths, against the first design (one
thread per cell; K1 and K2), and against variants of the source, to set
the plans and show what bounds the kernels; and K1's 2D path, the row
march, against its other plans, its first design and the floors of a
launch.

Run on a machine with a CUDA card, from the repository root:

    python3 scripts/bench_torch_stencil.py         # K3, K1 and K2, K1 2D
    python3 scripts/bench_torch_stencil.py --k3    # K3 alone
    python3 scripts/bench_torch_stencil.py --k1-2d # K1 2D alone (~2 min)

Shapes: K2 at the 256^3 TGV's velocity (K2a) and periodic, scaled
pressure (K2b), and the sphere's u, v and w (K2a, 160x130x130 cells) in
float32, the TGV's two in float64; K1 at the sphere's pressure
(130x130x160) and at a non-periodic stretched 256^3 level, in float32
and float64.  Against the plan (``cuda_stencil.launch_plan``) it times:

- ``cells``, the first design (the C entries ``zblocked_helmholtz_cells``
  and ``poisson_apply_separable_cells``);
- every other tile that takes the field, of ``cuda_stencil.TILES`` and
  of ``EXTRA_TILES`` (built by the source variant ``tiles``): vector
  tiles (two columns a thread, loaded and stored as one vector) and
  one-column tiles, with one to four rows a thread, each with its own
  plan; and the plan's tile with chunks of other lengths and with twice
  the blocks the card holds at once (two waves);
- source variants, each the shipped sources with text substitutions in
  ``march.cuh`` (or other flags), built from a copy under a temporary
  directory: ``fma`` (built without ``--fmad=false``: FMA contraction
  on; not the twin's bits), ``ahead0`` (the z march loads no plane
  ahead: the next plane is loaded in the plane that uses it), ``ahead2``
  (two planes ahead), ``stcs`` (the one-column tiles store with the
  streaming, evict-first hint), ``nohalo`` (the halo loads compiled out,
  the halo held at 0: not the twin's bits, an upper bound of what the
  halo costs), each with the plan for its own resident blocks;
- ``torch.mul(f, 2)``, one PyTorch kernel that moves the same bytes;
- on the sphere's shapes (21.5-21.6 MB, which the 50 MB L2 holds between
  the back-to-back launches of a warm timing), the plan and ``cells``
  with the L2 flushed before every launch.

K3 at the sphere's three components and at the TGV's 256^3, float32 and
float64, one launch forming the three: the plan (``cuda_stencil.
convection_launch_plan``) against every other tile of ``K3_EXTRA_TILES``
(the source variant ``k3tiles``), each with its own one-wave plan, the
plan's tile with chunks of other lengths and two waves, and the source
variants ``k3fma`` (FMA contraction on: not the twin's bits),
``k3ahead1`` and ``k3ahead3`` (one or three planes in flight ahead of
the two the block computes from, instead of two) and ``k3minb`` (every
instance bound to registers for 5 blocks an SM); then in
float32 against ``torch.mul(f, 2)`` on a tensor whose read and write
move the same bytes as the kernel's bound (the three extended arrays
read once, the three outputs written once), warm and with the L2
flushed before every launch.

Every run that keeps the bits is held to the twin at tolerance 0 first
(``fma`` and ``nohalo`` report their difference); then the pair is timed
in turns (plan, other, other, plan; median device time per apply, CUDA
events), each beside the bound (f read once and out written once at
3.35 TB/s).

Last, K1's 2D path (the row march of ``csrc/poisson_separable.cu``) at
the flagship's 450^2 pressure in float32, float64 and bfloat16 and at the
oscillating cylinder's 512^2 in float32: the plan (``cuda_stencil.
row_plan``) against every row tile (``cuda_stencil.ROW_TILES`` and
``EXTRA_ROW_TILES``, built by the variant ``rowtiles``) with its own
one-wave plan and with chunks of ``ROW_CHUNKS`` rows, the cell kernel
(the first design, ``poisson_apply_separable_cells``), the ``fma``
variant, and three floors: ``copy_`` of the field into another (the
same bytes read and written), ``torch.mul(f, 2)`` and an empty kernel's
launch.  Each run that keeps the bits equals the twin first; then every
candidate is timed in one sweep and in the same sweep reversed (median
device time per apply).  Then the SASS of both designs' instances
(``cuobjdump -sass``): instructions by kind, and those of the loop that
computes a cell (a row of VX cells a thread in the march).  Prints
the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, NamedTuple

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

#: the sources that include the march, each built for every variant
SOURCES = ("zblocked_helmholtz", "poisson_separable")
#: the file the variants' substitutions edit
HEADER = "march.cuh"
#: K3's source, the file its variants edit
K3 = "convection3d"
#: name: (substitutions in HEADER (text, its replacement at every
#: occurrence), the flags that replace EXTRA_FLAGS)
VARIANTS = {
    "fma": ([], ("-Xptxas", "-v")),
    "ahead0": ([("constexpr int kAhead = 1;", "constexpr int kAhead = 0;")],
               None),
    "ahead2": ([("constexpr int kAhead = 1;", "constexpr int kAhead = 2;")],
               None),
    "stcs": ([("    *p = v[0];", "    __stcs(p, v[0]);")], None),
    "nohalo": ([("hread[e] = (ih >= 0 && ih < nx) || px;",
                 "hread[e] = false;"),
                ("hread[e] = (jh >= 0 && jh < ny) || py;",
                 "hread[e] = false;")], None),
}
#: tiles the plan does not take, built by the variant ``tiles``: the
#: 32 x 8 tiles with one or two columns and one, two or four rows a
#: thread, and 64 x 16 with four rows of two columns
EXTRA_TILES = ((32, 8, 2, 2), (32, 8, 2, 1), (32, 8, 4, 1), (32, 8, 1, 1),
               (64, 16, 4, 2))
VARIANTS["tiles"] = ([(
    "#define ZB_TILES(X) X(64, 8, 2, 2) X(32, 16, 4, 2) X(32, 16, 4, 1)",
    "#define ZB_TILES(X) X(64, 8, 2, 2) X(32, 16, 4, 2) X(32, 16, 4, 1) "
    + " ".join(f"X{t}" for t in EXTRA_TILES))], None)
#: variants whose results are not the twin's
INEXACT = ("fma", "nohalo")
#: K3's tiles (TX, TY, RY, one column a thread) the plan does not take,
#: built by the variant ``k3tiles`` (bound to no count of blocks an SM)
K3_EXTRA_TILES = ((32, 16, 2, 1), (32, 16, 1, 1), (32, 8, 4, 1),
                  (32, 8, 2, 1), (64, 8, 4, 1), (64, 8, 1, 1), (64, 4, 1, 1),
                  (32, 4, 1, 1))
#: K3's variants, substitutions in its own source
K3_VARIANTS = {
    "k3fma": ([], ("-Xptxas", "-v")),
    "k3ahead1": ([("constexpr int kAhead = 2;", "constexpr int kAhead = 1;")],
                 None),
    "k3ahead3": ([("constexpr int kAhead = 2;", "constexpr int kAhead = 3;")],
                 None),
    "k3minb": ([("(sizeof(T) == 4 ? MINB32 : MINB64)", "5")], None),
    "k3tiles": ([("#define K3_TILES(X) X(32, 16, 4, 4, 1) X(32, 8, 1, 2, 2)",
                  "#define K3_TILES(X) X(32, 16, 4, 4, 1) X(32, 8, 1, 2, 2) "
                  + " ".join(f"X({t[0]}, {t[1]}, {t[2]}, 1, 1)"
                             for t in K3_EXTRA_TILES))], None),
}
#: chunk lengths timed beside the plan's, with every tile
CHUNKS = (8, 16, 32, 64)
#: K1's 2D row tiles (TX, RY, VX) the plan does not take, built by the
#: variant ``rowtiles``: four warps of two columns or of one a thread
#: marching two or four rows at a time, eight warps of two columns (one,
#: two, four rows), two warps of two columns (one, four rows) and one warp
#: of one column
EXTRA_ROW_TILES = ((256, 2, 2), (256, 4, 2), (128, 2, 1), (128, 4, 1),
                   (512, 1, 2), (512, 2, 2), (512, 4, 2), (128, 1, 2),
                   (128, 4, 2), (32, 1, 1))
#: K1's 2D variants: substitutions in its own source
ROW_VARIANTS = {"rowtiles": ([(
    "#define ROW_TILES(X) X(256, 1, 2) X(128, 1, 1)",
    "#define ROW_TILES(X) X(256, 1, 2) X(128, 1, 1) "
    + " ".join(f"X{t}" for t in EXTRA_ROW_TILES))], None)}
#: rows a chunk timed with every row tile (those a multiple of its RY),
#: beside each one's own plan
ROW_CHUNKS = (1, 2, 4, 8, 16)

EMPTY_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def _nvcc(src: Path, so: Path, flags) -> None:
    from petibm_tpu_torch import _kernels

    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, *flags, "-o", str(so),
           str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    return proc.stdout + proc.stderr


def _variant(tmp: Path, name: str) -> dict:
    """Build every source of SOURCES (K3's variants: K3's source) with
    ``name``'s substitutions and flags; returns {source: the library's
    path}."""
    from petibm_tpu_torch import _kernels

    subs, flags = {**VARIANTS, **K3_VARIANTS, **ROW_VARIANTS}[name]
    sources, edited = (((K3,), f"{K3}.cu") if name in K3_VARIANTS else
                       (("poisson_separable",), "poisson_separable.cu")
                       if name in ROW_VARIANTS else (SOURCES, HEADER))
    src = tmp / name
    shutil.copytree(_kernels._CSRC, src)
    path = src / edited
    text = path.read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"variant {name}: the source text is gone")
        text = text.replace(old, new)
    path.write_text(text)
    out = {}
    for source in sources:
        so = tmp / f"{source}-{name}.so"
        log = _nvcc(src / f"{source}.cu", so,
                    _kernels.EXTRA_FLAGS[source] if flags is None else flags)
        if source == K3:  # the registers of each instance
            fn = "?"
            for line in log.splitlines():
                if "Function properties for" in line:
                    fn = line.split("Function properties for")[-1].strip()
                elif "Used" in line or "spill stores" in line:
                    print(f"ptxas {name} {fn}: {line.strip()}", flush=True)
        out[source] = so
    return out


def _empty_kernel(tmp: Path):
    """A launch of an empty kernel (one block of 32 threads) on the
    current stream, as a function of one ignored argument."""
    import torch

    src, so = tmp / "empty.cu", tmp / "empty.so"
    src.write_text(EMPTY_SOURCE)
    _nvcc(src, so, ())
    fn = ctypes.CDLL(str(so)).empty_launch
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_void_p]

    def launch(_):
        if fn(torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("the empty kernel's launch failed")

    return launch


class Case(NamedTuple):
    """One field and the kernel that applies to it."""
    label: str
    source: str        # the library the kernel is in
    f: object          # the field
    launch: Callable   # plan -> the function of f that launches the march
    cells: Callable    # f -> the first design's result
    twin: Callable     # f -> the plain twin's result
    plan: Callable     # () -> the wrapper's plan
    resident: Callable  # tile -> resident blocks of the loaded library
    flushed: bool      # also timed with the L2 flushed


def _k2_case(label, f, vecs, periodic, scale, flushed):
    from petibm_tpu_torch.operators import cuda_stencil as cs

    scaled = scale is not None
    return Case(label, "zblocked_helmholtz", f,
                lambda p: lambda x: cs.launch(x, vecs, periodic, scale, p),
                lambda x: cs.launch_cells(x, vecs, periodic, scale),
                lambda x: cs.zblocked_helmholtz_apply_ref(x, vecs, periodic,
                                                          scale),
                lambda: cs.plan_on_card(f, scaled),
                lambda tile: cs.resident_blocks(f.device, f.dtype, scaled,
                                                tile), flushed)


def _k1_case(label, phi, level, flushed):
    from petibm_tpu_torch.operators import cuda_stencil as cs

    return Case(label, "poisson_separable", phi,
                lambda p: lambda x: cs.separable_launch(x, level, p),
                lambda x: cs.separable_launch_cells(x, level),
                lambda x: cs.poisson_apply_separable_ref(x, level),
                lambda: cs.separable_plan_on_card(phi),
                lambda tile: cs.separable_resident_blocks(phi.device,
                                                          phi.dtype, tile),
                flushed)


def _cases(tmp: str, dtype) -> list:
    """The cases at the main paths' shapes."""
    import numpy as np
    import torch

    import chip_smoke
    from petibm_tpu_torch.linalg.mg import poisson_level0
    from petibm_tpu_torch.operators import cuda_stencil as cs

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape):
        return torch.randn(tuple(shape), generator=gen, device="cuda",
                           dtype=dtype)

    cases = []
    names = (("tgv256", "u"), ("sphere", "uvw"))
    if dtype == torch.float64:
        names = names[:1]
    for name, comps in names:
        make = (chip_smoke.tgv3d_config if name == "tgv256"
                else chip_smoke.sphere_config)
        cfg = make(os.path.join(tmp, f"{name}_{str(dtype)[6:]}"))
        mesh, bcs = chip_smoke._mesh_and_bcs(cfg)
        A = cs.make_cuda_momentum(mesh, bcs, cfg["parameters"]["dt"],
                                  0.5 * cfg["flow"]["nu"], dtype=dtype,
                                  device="cuda")
        for comp in comps:
            f = randn(mesh.shape("uvw".index(comp)))
            cases.append(_k2_case(f"K2a {name} {comp}", f, A.vecs[comp],
                                  A.periodic, None, name == "sphere"))
        if name == "tgv256":
            level = poisson_level0(mesh.dxp, mesh.periodic, dtype=dtype,
                                   device="cuda",
                                   scale=cfg["parameters"]["dt"])
            k2b = cs.make_cuda_poisson_zblocked(level)
            cases.append(_k2_case(f"K2b {name} p", randn(level.shape),
                                  k2b.vecs, k2b.periodic, k2b.scale, False))
    # K1: the sphere's pressure, and a stretched non-periodic 256^3 level
    cfg = chip_smoke.sphere_config(os.path.join(tmp, f"k1_{str(dtype)[6:]}"))
    mesh = chip_smoke._mesh_and_bcs(cfg)[0]
    level = poisson_level0(mesh.dxp, mesh.periodic, dtype=dtype,
                           device="cuda", scale=cfg["parameters"]["dt"])
    cases.append(_k1_case("K1 sphere p", randn(level.shape), level, True))
    widths = [np.geomspace(0.01, 0.05, 256)] * 3
    level = poisson_level0(widths, [False] * 3, dtype=dtype, device="cuda",
                           scale=0.01)
    cases.append(_k1_case("K1 stretched 256^3", randn(level.shape), level,
                          False))
    return cases


def _name(plan) -> str:
    return f"{plan.tx}x{plan.ty} ry {plan.ry} vx {plan.vx} kz {plan.kz}"


def _with_library(source: str, lib, fn):
    """``fn()`` with the library ``lib`` of ``source`` in place of the
    shipped one (and its own occupancy: a variant with more registers
    holds fewer blocks at once)."""
    from petibm_tpu_torch import _kernels
    from petibm_tpu_torch.operators import cuda_stencil as cs

    shipped = _kernels._LIBS[source]
    _kernels._LIBS[source] = lib
    cs._RESIDENT.clear()
    try:
        return fn()
    finally:
        _kernels._LIBS[source] = shipped
        cs._RESIDENT.clear()


def _plans(case: Case, plan, libs):
    """(variant, plan) of every other tile that takes the field, each with
    its own plan (one wave of its resident blocks; ``EXTRA_TILES`` from
    the variant ``tiles``), and of the plan's tile with chunks of
    ``CHUNKS`` planes and with two waves."""
    from petibm_tpu_torch.operators import cuda_stencil as cs

    shape = tuple(case.f.shape)

    def tile_plan(variant, tile):
        return cs.plan_for_tile(shape, tile, _with_library(
            case.source, libs[case.source, variant],
            lambda: case.resident(tile)))

    out = [(variant, tile_plan(variant, t))
           for variant, tiles in (("shipped", cs.TILES),
                                  ("tiles", EXTRA_TILES))
           for t in tiles if shape[2] % t[3] == 0]
    slots = case.resident(plan[:4])
    out += [("shipped", plan._replace(kz=kz)) for kz in CHUNKS]
    out.append(("shipped", cs.plan_for_tile(shape, plan[:4], 2 * slots)))
    return [(variant, p) for variant, p in dict.fromkeys(out) if p != plan]


def _time_flushed(fn, arg, applies: int = 100) -> float:
    """Median device ms of one ``fn(arg)`` with the L2 flushed (a 256 MB
    buffer written) before each, CUDA events around the apply alone."""
    import torch

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    times = []
    for _ in range(applies):
        flush.fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bench(case: Case, libs: dict, tag: str) -> None:
    """The plan of ``case`` against the first design, the other plans and
    the source variants, and ``torch.mul``, each in turns."""
    import torch

    import chip_smoke
    from petibm_tpu_torch import _kernels
    from petibm_tpu_torch.operators import cuda_stencil as cs

    f = case.f
    shape = tuple(f.shape)
    shipped = libs[case.source, "shipped"]
    _kernels._LIBS[case.source] = shipped
    cs._RESIDENT.clear()
    plan = case.plan()
    bound_us = 2 * f.numel() * f.element_size() / chip_smoke.HBM_BYTES_PER_S \
        * 1e6
    want = case.twin(f)
    head = f"{case.label} {shape} {tag} (bound {bound_us:.2f} us)"
    print(f"{head}: resident blocks of each tile " + ", ".join(
        f"{t}: {case.resident(t)}" for t in cs.TILES), flush=True)

    def march(p, variant="shipped"):
        lib, launch = libs[case.source, variant], case.launch(p)

        def run(x):
            _kernels._LIBS[case.source] = lib
            return launch(x)
        return run

    def cells(x):
        _kernels._LIBS[case.source] = shipped
        return case.cells(x)

    others = [("cells", cells, True)]
    others += [(_name(p) + ("" if variant == "shipped" else f" ({variant})"),
                march(p, variant), True)
               for variant, p in _plans(case, plan, libs)]
    others += [(v, march(_with_library(case.source, libs[case.source, v],
                                       case.plan), v), v not in INEXACT)
               for v in VARIANTS if v != "tiles"]
    mine = march(plan)
    if not torch.equal(mine(f), want):
        raise AssertionError(f"{head}: the plan differs from the twin")
    for name, run, exact in others:
        err = float((run(f) - want).abs().max())
        if exact and err != 0.0:
            raise AssertionError(f"{head}: {name} differs from the twin by "
                                 f"{err}")
        times = [chip_smoke._time_ms(g, f, 60)[0] * 1e3
                 for g in (mine, run, run, mine)]
        print(f"{head}: plan {_name(plan)} {times[0]:.2f}, {times[3]:.2f} "
              f"us (share {bound_us / min(times[0], times[3]):.3f}); {name} "
              f"{times[1]:.2f}, {times[2]:.2f} us (share "
              f"{bound_us / min(times[1], times[2]):.3f})"
              + ("" if exact else f"; max|diff| from the twin {err:.3e}"),
              flush=True)
    # the same bytes moved by one PyTorch elementwise kernel
    copy = [chip_smoke._time_ms(g, f, 60)[0] * 1e3
            for g in (mine, lambda x: torch.mul(x, 2.0),
                      lambda x: torch.mul(x, 2.0), mine)]
    print(f"{head}: plan {copy[0]:.2f}, {copy[3]:.2f} us; torch.mul(f, 2) "
          f"{copy[1]:.2f}, {copy[2]:.2f} us (share "
          f"{bound_us / min(copy[1], copy[2]):.3f})", flush=True)
    if case.flushed:
        flushed = [_time_flushed(g, f) * 1e3
                   for g in (mine, cells, cells, mine)]
        print(f"{head} L2 flushed before each apply: plan {flushed[0]:.2f}, "
              f"{flushed[3]:.2f} us; cells {flushed[1]:.2f}, "
              f"{flushed[2]:.2f} us", flush=True)
    _kernels._LIBS[case.source] = shipped


def _k3_cases(tmp: str, dtype) -> list:
    """(label, extended arrays, 1/dl) of the sphere and the 256^3 TGV."""
    import torch

    import chip_smoke
    from petibm_tpu_torch.operators import cuda_stencil as cs

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for name, make in (("sphere", chip_smoke.sphere_config),
                       ("tgv256", chip_smoke.tgv3d_config)):
        cfg = make(os.path.join(tmp, f"k3_{name}_{str(dtype)[6:]}"))
        mesh, bcs = chip_smoke._mesh_and_bcs(cfg)
        conv = cs.make_cuda_convection(mesh, bcs, dtype=dtype, device="cuda")
        q = {k: torch.randn(tuple(mesh.shape(c)), generator=gen,
                            device="cuda", dtype=dtype)
             for c, k in enumerate("uvw")}
        state = bcs.init_state(q)
        cases.append((f"K3 {name}", [bcs.extend(q[k], c, state)
                                     for c, k in enumerate("uvw")],
                      conv.inv_dl))
    return cases


def _bench_k3(label: str, ext, inv_dl, libs: dict, tag: str) -> None:
    """K3's plan against its other tiles, chunks, two waves and the
    ``k3fma`` variant, and (float32) against ``torch.mul`` moving the same
    bytes, warm and with the L2 flushed; each in turns."""
    import torch

    import chip_smoke
    from petibm_tpu_torch import _kernels
    from petibm_tpu_torch.operators import cuda_stencil as cs

    shapes = [tuple(e.shape) for e in ext]
    union = cs.convection_union(shapes)
    shipped = libs[K3, "shipped"]
    _kernels._LIBS[K3] = shipped
    cs._RESIDENT.clear()
    plan = cs.convection_plan_on_card(ext)
    want = [cs.convection3d_apply_ref(ext, c, inv_dl[c]) for c in range(3)]
    size = ext[0].element_size()
    nbytes = (sum(e.numel() for e in ext) + sum(w.numel() for w in want)) \
        * size
    bound_us = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e6
    head = (f"{label} u/v/w {' '.join(str(tuple(w.shape)) for w in want)} "
            f"{tag} (bound {bound_us:.2f} us, {nbytes / 1e6:.1f} MB)")

    def resident(variant, tile):
        return _with_library(K3, libs[K3, variant], lambda: (
            cs.convection_resident_blocks(ext[0].device, ext[0].dtype,
                                          tile)))

    print(f"{head}: resident blocks of the plan's tile "
          f"{resident('shipped', plan[:4])}", flush=True)

    def march(p, variant="shipped"):
        lib = libs[K3, variant]

        def run(e):
            _kernels._LIBS[K3] = lib
            return cs.convection_launch(e, inv_dl, p)
        return run

    others = [(_name(p) + ("" if v == "shipped" else f" ({v})"),
               march(p, v), True)
              for v, p in dict.fromkeys(
                  [(v, cs.plan_for_tile(union, t, resident(v, t)))
                   for v, tiles in (("shipped", cs.CONVECTION_TILES),
                                    ("k3tiles", K3_EXTRA_TILES))
                   for t in tiles]
                  + [("shipped", plan._replace(kz=kz)) for kz in CHUNKS]
                  + [("shipped", cs.plan_for_tile(
                      union, plan[:4], 2 * resident("shipped", plan[:4])))])
              if p != plan]
    for v in K3_VARIANTS:
        if v != "k3tiles":
            p = cs.plan_for_tile(union, plan[:4], resident(v, plan[:4]))
            others.append((f"{v} {_name(p)}", march(p, v), v != "k3fma"))
    mine = march(plan)
    if not all(torch.equal(g, w) for g, w in zip(mine(ext), want)):
        raise AssertionError(f"{head}: the plan differs from the twin")
    for name, run, exact in others:
        err = max(float((g - w).abs().max()) for g, w in zip(run(ext), want))
        if exact and err != 0.0:
            raise AssertionError(f"{head}: {name} differs from the twin by "
                                 f"{err}")
        times = [chip_smoke._time_ms(g, ext, 60)[0] * 1e3
                 for g in (mine, run, run, mine)]
        print(f"{head}: plan {_name(plan)} {times[0]:.2f}, {times[3]:.2f} "
              f"us (share {bound_us / min(times[0], times[3]):.3f}); {name} "
              f"{times[1]:.2f}, {times[2]:.2f} us (share "
              f"{bound_us / min(times[1], times[2]):.3f})"
              + ("" if exact else f"; max|diff| from the twin {err:.3e}"),
              flush=True)
    _kernels._LIBS[K3] = shipped
    if ext[0].dtype != torch.float32:
        return
    # one PyTorch elementwise kernel moving the same bytes (read + write)
    flat = torch.randn(nbytes // (2 * size), device="cuda")

    def mul(_):
        return torch.mul(flat, 2.0)

    copy = [chip_smoke._time_ms(g, ext, 60)[0] * 1e3
            for g in (mine, mul, mul, mine)]
    flushed = [_time_flushed(g, ext) * 1e3 for g in (mine, mul, mul, mine)]
    print(f"{head}: plan {copy[0]:.2f}, {copy[3]:.2f} us; torch.mul(f, 2) "
          f"{copy[1]:.2f}, {copy[2]:.2f} us (share "
          f"{bound_us / min(copy[1], copy[2]):.3f}); L2 flushed before each "
          f"apply: plan {flushed[0]:.2f}, {flushed[3]:.2f} us; torch.mul "
          f"{flushed[1]:.2f}, {flushed[2]:.2f} us", flush=True)


def _cases_2d(tmp: str) -> list:
    """(label, phi, level) of K1's 2D path: the flagship's 450^2 pressure
    in float32, float64 and bfloat16, the oscillating cylinder's 512^2 in
    float32."""
    import torch

    import chip_smoke
    from petibm_tpu_torch.linalg.mg import poisson_level0

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for name, make, dtypes in (
            ("450x450", chip_smoke.flagship_config,
             (torch.float32, torch.float64, torch.bfloat16)),
            ("oscillating", chip_smoke.oscillating_config, (torch.float32,))):
        cfg = make(os.path.join(tmp, f"k1_2d_{name}"))
        mesh = chip_smoke._mesh_and_bcs(cfg)[0]
        for dtype in dtypes:
            level = poisson_level0(mesh.dxp, mesh.periodic, dtype=dtype,
                                   device="cuda",
                                   scale=cfg["parameters"]["dt"])
            phi = torch.randn(tuple(level.shape), generator=gen,
                              device="cuda", dtype=dtype)
            cases.append((f"K1 2D {name} {tuple(phi.shape)} "
                          f"{str(dtype)[6:]}", phi, level))
    return cases


def _row_candidates(phi, libs) -> list:
    """(name, variant, plan) of every row tile that takes ``phi`` (a
    vector tile: nx a multiple of its vector), each with its own one-wave
    plan and with chunks of ``ROW_CHUNKS`` rows."""
    from petibm_tpu_torch.operators import cuda_stencil as cs

    shape = cs.as_march(tuple(phi.shape))
    out = []
    for variant, tiles in (("shipped", cs.ROW_TILES), (
            "rowtiles", tuple((t[0], 1, t[1], t[2])
                              for t in EXTRA_ROW_TILES))):
        for tile in tiles:
            if shape[2] % tile[3]:
                continue
            slots = _with_library(
                "poisson_separable", libs["poisson_separable", variant],
                lambda: cs.separable_resident_blocks(phi.device, phi.dtype,
                                                     tile))
            wave = cs.row_plan_for_tile(tuple(phi.shape), tile, slots)
            for plan in dict.fromkeys(
                    [wave] + [cs.Plan(*tile, ky) for ky in ROW_CHUNKS
                              if ky % tile[2] == 0]):
                tag = " (one wave)" if plan == wave else ""
                out.append((f"{plan.tx} ry {plan.ry} vx {plan.vx} ky "
                            f"{plan.kz}{tag}"
                            + ("" if variant == "shipped"
                               else f" ({variant}, {slots} resident)"),
                            variant, plan))
    return out


def _bench_2d(tmp: str, libs: dict, empty) -> None:
    """K1's 2D row march against its candidates and floors (the module
    docstring's last paragraph), case by case."""
    import torch

    import chip_smoke
    from petibm_tpu_torch import _kernels
    from petibm_tpu_torch.operators import cuda_stencil as cs

    source = "poisson_separable"
    shipped = libs[source, "shipped"]
    for label, phi, level in _cases_2d(tmp):
        _kernels._LIBS[source] = shipped
        cs._RESIDENT.clear()
        plan = cs.separable_plan_on_card(phi)
        want = cs.poisson_apply_separable_ref(phi, level)
        bound_us = (2 * phi.numel() * phi.element_size()
                    / chip_smoke.HBM_BYTES_PER_S * 1e6)

        def launch(variant, fn):
            lib = libs[source, variant]

            def run(x):
                _kernels._LIBS[source] = lib
                return fn(x)
            return run

        copy_out = torch.empty_like(phi)
        runs = [(f"plan {plan.tx} ry {plan.ry} vx {plan.vx} ky {plan.kz}",
                 launch("shipped", lambda x: cs.poisson_apply_separable(
                     x, level)), True),
                ("cell kernel", launch("shipped", lambda x: cs.
                                       separable_launch_cells(x, level)), True)]
        runs += [(name, launch(variant, lambda x, p=p: cs.separable_launch(
            x, level, p)), True)
            for name, variant, p in _row_candidates(phi, libs) if p != plan]
        runs += [("fma variant, the plan", launch("fma", lambda x: cs.
                                                  separable_launch(x, level,
                                                                   plan)),
                  False),
                 ("floor: copy_", lambda x: copy_out.copy_(x), None),
                 ("floor: torch.mul(f, 2)", lambda x: torch.mul(x, 2.0),
                  None),
                 ("floor: empty kernel", empty, None)]
        for name, run, exact in runs:
            if exact is None:
                continue
            err = float((run(phi).double() - want.double()).abs().max())
            if exact and err != 0.0:
                raise AssertionError(f"{label}: {name} differs from the twin "
                                     f"by {err}")
            if not exact:
                print(f"{label}: {name}: max|diff| from the twin {err:.3e}",
                      flush=True)
        times = {name: [] for name, _, _ in runs}
        for name, run, _ in runs + runs[::-1]:
            times[name].append(chip_smoke._time_ms(run, phi, 100)[0] * 1e3)
        med = {name: statistics.median(t) for name, t in times.items()}
        print(f"{label} (bound {bound_us:.2f} us, plan {tuple(plan)}): device "
              "us per apply, a sweep and the sweep reversed:", flush=True)
        for name, ts in sorted(times.items(), key=lambda kv: med[kv[0]]):
            print(f"  {name}: {ts[0]:.2f}, {ts[1]:.2f} (share "
                  f"{bound_us / med[name]:.3f})", flush=True)
        kernels = [n for n, _, e in runs if e]
        best = min(kernels, key=med.get)
        print(f"{label}: fastest kernel run {best} {med[best]:.2f} us; the "
              f"plan {med[runs[0][0]]:.2f} us; the cell kernel "
              f"{med['cell kernel']:.2f} us; plan / copy_ "
              f"{med[runs[0][0]] / med['floor: copy_']:.3f}", flush=True)
    _kernels._LIBS[source] = shipped
    _sass_2d()


#: SASS mnemonics counted by kind
SASS_KINDS = {"global loads": ("LDG",), "global stores": ("STG",),
              "shuffles": ("SHFL",),
              "float ops": ("FADD", "FMUL", "FFMA", "DADD", "DMUL", "DFMA"),
              "division helpers": ("I2F", "F2I", "MUFU", "IABS"),
              "calls": ("CALL",), "branches": ("BRA",)}
#: the 2D designs' instances (parts of their mangled names): every row
#: march, and the cell kernel with DIM = 2
SASS_2D = (("rowmarch",), ("poisson_apply_separable_kernel", "Li2EEEv"))


def _sass_2d() -> None:
    """The instances of both 2D designs in the shipped library's SASS
    (``cuobjdump -sass``): instructions by kind over each function
    and over the widest backward branch's span (the cell kernel's
    grid-stride loop: one cell a thread and pass, and the subroutine it
    calls for 64-bit division; the march's row loop: VX cells a thread
    and row, unrolled as the compiler chose).  Their SASS goes beside the
    library, to ``build/torch_kernels/<library>.2d.sass.txt``."""
    import re

    from petibm_tpu_torch import _kernels

    cuobjdump = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    path, _ = _kernels.build("poisson_separable")
    text = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    kept = []
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        name = func.split("\n", 1)[0].strip()
        if not any(all(k in name for k in keys) for keys in SASS_2D):
            continue
        kept.append("Function : " + func)
        ins = re.findall(r"/\*([0-9a-f]{4})\*/\s+(@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)([^;]*);", func)
        addr = [int(a, 16) for a, _, _, _ in ins]
        ops = [op for _, _, op, _ in ins]
        span = (0, 0)
        for k, (_, _, op, rest) in enumerate(ins):
            target = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and target:
                to = int(target.group(1), 16)
                if to < addr[k] and to in addr and \
                        k + 1 - addr.index(to) > span[1] - span[0]:
                    span = (addr.index(to), k + 1)

        def kinds(seq):
            return ", ".join(f"{kind} {sum(o.split('.')[0] in m or o in m for o in seq)}"
                             for kind, m in SASS_KINDS.items())
        print(f"SASS {name}: {len(ops)} instructions ({kinds(ops)}); the "
              f"widest loop {span[1] - span[0]} ({kinds(ops[span[0]:span[1]])})",
              flush=True)
    path.with_suffix(".2d.sass.txt").write_text("\n".join(kept))


def main() -> int:
    import torch

    from petibm_tpu_torch import _kernels

    if not torch.cuda.is_available():
        raise RuntimeError("bench_torch_stencil.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = {(s, "shipped"): _kernels.library(s) for s in SOURCES + (K3,)}
        only_2d = "--k1-2d" in sys.argv[1:]
        variants = (["fma", *ROW_VARIANTS] if only_2d else
                    [*VARIANTS, *K3_VARIANTS, *ROW_VARIANTS])
        with ThreadPoolExecutor(len(variants) + 1) as pool:
            empty = pool.submit(_empty_kernel, Path(tmp))
            built = pool.map(lambda v: (v, _variant(Path(tmp), v)), variants)
            for name, paths in built:
                for source, so in paths.items():
                    libs[source, name] = ctypes.CDLL(str(so))
            empty = empty.result()
        if only_2d:
            _bench_2d(tmp, libs, empty)
            return 0
        for dtype in (torch.float32, torch.float64):
            for label, ext, inv_dl in _k3_cases(tmp, dtype):
                _bench_k3(label, ext, inv_dl, libs, str(dtype)[6:])
        if "--k3" in sys.argv[1:]:
            return 0
        for dtype in (torch.float32, torch.float64):
            for case in _cases(tmp, dtype):
                _bench(case, libs, str(dtype)[6:])
        _bench_2d(tmp, libs, empty)
    return 0


if __name__ == "__main__":
    sys.exit(main())
