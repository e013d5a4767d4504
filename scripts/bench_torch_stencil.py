"""K2 (csrc/zblocked_helmholtz.cu, the 3D 7-point apply) at the main
paths' shapes: the launch plan against other tiles and chunk lengths,
against the first design (one thread per cell), and against variants of
its own source, to set the plan and show what bounds the kernel.

Run on a machine with a CUDA card, from the repository root:

    python3 scripts/bench_torch_stencil.py

Shapes: the 256^3 TGV's velocity (K2a) and periodic, scaled pressure
(K2b), and the sphere's u, v and w (K2a, 160x130x130 cells) in float32;
the TGV's two in float64.  Against the plan (``cuda_stencil.launch_plan``)
it times:

- ``cells``, the first design (the C entry ``zblocked_helmholtz_cells``);
- every other tile that takes the field, of ``cuda_stencil.TILES`` and
  of ``EXTRA_TILES`` (built by the source variant ``tiles``): vector
  tiles (two columns a thread, loaded and stored as one vector) and
  one-column tiles, with one to four rows a thread, each with its own
  plan; and the plan's tile with chunks of other lengths and with twice
  the blocks the card holds at once (two waves);
- source variants, each the shipped source with one text substitution
  (or other flags), built from a copy under a temporary directory:
  ``fma`` (built without ``--fmad=false``: FMA contraction on; not the
  twin's bits), ``ahead0`` (the z march loads no plane ahead: the next
  plane is loaded in the plane that uses it), ``ahead2`` (two planes
  ahead), ``stcs`` (the one-column tiles store with the streaming,
  evict-first hint), ``nohalo`` (the halo loads compiled out, the halo
  held at 0: not the twin's bits, an upper bound of what the halo costs),
  each with the plan for its own resident blocks;
- on the sphere's shapes (21.5 MB, which the 50 MB L2 holds between the
  back-to-back launches of a warm timing), the plan and ``cells`` with
  the L2 flushed before every launch.

Every run that keeps the bits is held to the twin at tolerance 0 first
(``fma`` and ``nohalo`` report their difference); then the pair is timed
in turns (plan, other, other, plan; median device time per apply, CUDA
events), each beside the bound (f read once and out written once at
3.35 TB/s).  Prints the card's name and power limit first.
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

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SOURCE = "zblocked_helmholtz"
#: name: (substitutions (text, its replacement at every occurrence),
#: the flags that replace EXTRA_FLAGS)
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
#: chunk lengths timed beside the plan's, with every tile
CHUNKS = (8, 16, 32, 64)


def _variant(tmp: Path, name: str) -> Path:
    """Build the K2 source with ``name``'s substitutions and flags;
    returns the library's path."""
    from petibm_tpu_torch import _kernels

    subs, flags = VARIANTS[name]
    src = tmp / name
    shutil.copytree(_kernels._CSRC, src)
    path = src / f"{SOURCE}.cu"
    text = path.read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"variant {name}: the source text is gone")
        text = text.replace(old, new)
    path.write_text(text)
    so = tmp / f"{SOURCE}-{name}.so"
    extra = _kernels.EXTRA_FLAGS[SOURCE] if flags is None else flags
    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, *extra, "-o", str(so),
           str(path)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{proc.stderr}")
    return so


def _cases(tmp: str, dtype):
    """(label, f, vecs, periodic, scale) at the main paths' shapes."""
    import torch

    import chip_smoke
    from petibm_tpu_torch.linalg.mg import poisson_level0
    from petibm_tpu_torch.operators import cuda_stencil as cs

    gen = torch.Generator(device="cuda").manual_seed(0)
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
            f = torch.randn(mesh.shape("uvw".index(comp)), generator=gen,
                            device="cuda", dtype=dtype)
            cases.append((f"K2a {name} {comp}", f, A.vecs[comp], A.periodic,
                          None))
        if name == "tgv256":
            level = poisson_level0(mesh.dxp, mesh.periodic, dtype=dtype,
                                   device="cuda",
                                   scale=cfg["parameters"]["dt"])
            k2b = cs.make_cuda_poisson_zblocked(level)
            f = torch.randn(tuple(level.shape), generator=gen, device="cuda",
                            dtype=dtype)
            cases.append((f"K2b {name} p", f, k2b.vecs, k2b.periodic,
                          k2b.scale))
    return cases


def _name(plan) -> str:
    return f"{plan.tx}x{plan.ty} ry {plan.ry} vx {plan.vx} kz {plan.kz}"


def _plans(f, scaled, plan, libs):
    """(library, plan) of every other tile that takes the field, each with
    its own plan (one wave of its resident blocks; ``EXTRA_TILES`` from
    the variant ``tiles``), and of the plan's tile with chunks of
    ``CHUNKS`` planes and with two waves."""
    from petibm_tpu_torch.operators import cuda_stencil as cs

    shape = tuple(f.shape)
    out = [(lib, cs.plan_for_tile(shape, t, _resident(libs[lib], f, scaled,
                                                      t)))
           for lib, tiles in (("shipped", cs.TILES), ("tiles", EXTRA_TILES))
           for t in tiles if shape[2] % t[3] == 0]
    slots = cs.resident_blocks(f.device, f.dtype, scaled, plan[:4])
    out += [("shipped", plan._replace(kz=kz)) for kz in CHUNKS]
    out.append(("shipped", cs.plan_for_tile(shape, plan[:4], 2 * slots)))
    return [(lib, p) for lib, p in dict.fromkeys(out) if p != plan]


def _with_library(lib, fn):
    """``fn()`` with the K2 library ``lib`` in place of the shipped one
    (and its own occupancy: a variant with more registers holds fewer
    blocks at once)."""
    from petibm_tpu_torch import _kernels
    from petibm_tpu_torch.operators import cuda_stencil as cs

    shipped = _kernels._LIBS[SOURCE]
    _kernels._LIBS[SOURCE] = lib
    cs._RESIDENT.clear()
    try:
        return fn()
    finally:
        _kernels._LIBS[SOURCE] = shipped
        cs._RESIDENT.clear()


def _resident(lib, f, scaled, tile):
    from petibm_tpu_torch.operators import cuda_stencil as cs

    return _with_library(lib, lambda: cs.resident_blocks(f.device, f.dtype,
                                                         scaled, tile))


def _variant_plan(lib, f, scaled):
    """The plan with the variant library ``lib``'s own resident blocks."""
    from petibm_tpu_torch.operators import cuda_stencil as cs

    return _with_library(lib, lambda: cs.plan_on_card(f, scaled))


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


def main() -> int:
    import torch

    import chip_smoke
    from petibm_tpu_torch import _kernels
    from petibm_tpu_torch.operators import cuda_stencil as cs

    if not torch.cuda.is_available():
        raise RuntimeError("bench_torch_stencil.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"shipped": _kernels.library(SOURCE)}
        with ThreadPoolExecutor(len(VARIANTS)) as pool:
            built = pool.map(lambda v: (v, _variant(Path(tmp), v)), VARIANTS)
            for name, so in built:
                libs[name] = ctypes.CDLL(str(so))
        for dtype in (torch.float32, torch.float64):
            tag = str(dtype)[6:]
            size = torch.finfo(dtype).bits // 8
            for label, f, vecs, periodic, scale in _cases(tmp, dtype):
                shape = tuple(f.shape)
                _kernels._LIBS[SOURCE] = libs["shipped"]
                cs._RESIDENT.clear()
                plan = cs.plan_on_card(f, scale is not None)
                bound_us = (2 * f.numel() * size / chip_smoke.HBM_BYTES_PER_S
                            * 1e6)
                want = cs.zblocked_helmholtz_apply_ref(f, vecs, periodic,
                                                       scale)
                head = f"{label} {shape} {tag} (bound {bound_us:.2f} us)"
                resident = [cs.resident_blocks(f.device, dtype,
                                               scale is not None, t)
                            for t in cs.TILES]
                print(f"{head}: resident blocks of each tile " + ", ".join(
                    f"{t}: {n}" for t, n in zip(cs.TILES, resident)),
                    flush=True)

                def march(p, lib="shipped"):
                    def run(x):
                        _kernels._LIBS[SOURCE] = libs[lib]
                        return cs.launch(x, vecs, periodic, scale, p)
                    return run

                def cells(x):
                    _kernels._LIBS[SOURCE] = libs["shipped"]
                    return cs.launch_cells(x, vecs, periodic, scale)

                others = [("cells", cells, True)]
                others += [(_name(p) + ("" if lib == "shipped"
                                        else f" ({lib})"), march(p, lib),
                            True)
                           for lib, p in _plans(f, scale is not None, plan,
                                                libs)]
                others += [(v, march(_variant_plan(libs[v], f,
                                                   scale is not None), v),
                            v not in INEXACT)
                           for v in VARIANTS if v != "tiles"]
                mine = march(plan)
                if not torch.equal(mine(f), want):
                    raise AssertionError(f"{head}: the plan differs from "
                                         "the twin")
                for name, run, exact in others:
                    err = float((run(f) - want).abs().max())
                    if exact and err != 0.0:
                        raise AssertionError(f"{head}: {name} differs from "
                                             f"the twin by {err}")
                    times = [chip_smoke._time_ms(g, f, 60)[0] * 1e3
                             for g in (mine, run, run, mine)]
                    print(f"{head}: plan {_name(plan)} "
                          f"{times[0]:.2f}, {times[3]:.2f} us (share "
                          f"{bound_us / min(times[0], times[3]):.3f}); {name} "
                          f"{times[1]:.2f}, {times[2]:.2f} us (share "
                          f"{bound_us / min(times[1], times[2]):.3f})"
                          + ("" if exact else f"; max|diff| from the twin "
                             f"{err:.3e}"), flush=True)
                # the same bytes moved by one PyTorch elementwise kernel
                copy = [chip_smoke._time_ms(g, f, 60)[0] * 1e3
                        for g in (mine, lambda x: torch.mul(x, 2.0),
                                  lambda x: torch.mul(x, 2.0), mine)]
                print(f"{head}: plan {copy[0]:.2f}, {copy[3]:.2f} us; "
                      f"torch.mul(f, 2) {copy[1]:.2f}, {copy[2]:.2f} us "
                      f"(share {bound_us / min(copy[1], copy[2]):.3f})",
                      flush=True)
                if label.startswith("K2a sphere"):
                    flushed = [_time_flushed(g, f) * 1e3
                               for g in (mine, cells, cells, mine)]
                    print(f"{head} L2 flushed before each apply: plan "
                          f"{flushed[0]:.2f}, {flushed[3]:.2f} us; cells "
                          f"{flushed[1]:.2f}, {flushed[2]:.2f} us",
                          flush=True)
        _kernels._LIBS[SOURCE] = libs["shipped"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
