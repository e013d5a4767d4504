"""K4/K5 (csrc/line_sweep.cu) at the multigrid levels 0-2 of the flagship
(450^2, 225^2, 113^2) and of the sphere (130x130x160, 65x65x80,
33x33x40), every line
direction: the launch plan against the other plans the shape admits and
against variants of its own source, to set the plan's thresholds and show
what bounds the kernel.

Run on a machine with a CUDA card, from the repository root:

    python3 scripts/bench_torch_sweep.py

Against the plan (``cuda_sweep.launch_plan``) it times:

- the block path (the first design) and every other row count a lane that
  holds the line;
- ``r8``, the source with an R = 8 register instance added (lines of up
  to 256 rows), on the lines of 129 to 256 rows: against the plan's R = 5
  for the sphere's 160- and 130-row lines, and against the plan's block
  path for the flagship's 225-row lines;
- the other ``warp_tiles`` width (8 or 16 lines a block);
- source variants, each the shipped source with one text substitution,
  built from a copy under a temporary directory: ``warps4`` (4 lines a
  ``warp_rows`` block instead of 8), ``nopass`` (the PCR passes compiled out:
  the kernel loads, builds the right side, divides and stores),
  ``ieeediv`` (the passes' float32 quotients by `/`, each with the range
  check and branch to a slow path the compiler adds, instead of
  ``quotient_fast``/``quotient_scaled``), ``fastdiv`` (approximate division, not the twin's
  bits: an upper bound of what the divisions cost), ``occ5`` and
  ``occ6`` (launch bounds asking for 40 or 48 warps an SM) and ``nopad``
  (the passes given the line's length, so that their range tests run,
  instead of the warp's 32 R rows).

Every run is held to the twin bit for bit (``nopass`` and ``fastdiv``
excepted), then the
pair is timed in turns (plan, other, other, plan; median device time per
sweep, CUDA events).  Float32 on levels 0-2, float64 on the finest.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

#: name: substitutions (file of csrc/, text, its replacement at every
#: occurrence)
VARIANTS = {
    "r8": [("line_sweep.cu", "constexpr int kMaxRows = 5;",
            "constexpr int kMaxRows = 8;"),
           ("line_sweep.cu",
            "    default: return (int)cudaErrorInvalidValue;\n  }\n}",
            "    case 8: return launch_warp<T, 8>(phi, rhs, out, f, g, path, "
            "lines, w, stream);\n"
            "    default: return (int)cudaErrorInvalidValue;\n  }\n}")],
    "warps4": [("line_sweep.cu", "constexpr int kRowsWarps = 8;",
                "constexpr int kRowsWarps = 4;")],
    "nopass": [("pcr_warp.cuh",
                "    if (S >= steps) return;  // the same for every lane of the warp",
                "    return;")],
    # the passes' quotients by `/`, each with the range check and branch
    # to a slow path the compiler adds, instead of quotient_fast/scaled
    "ieeediv": [("line_sweep.cu", "warp_passes<T, R, 0, true>",
                 "warp_passes<T, R, 0>")],
    # approximate float32 division: not the twin's bits, an upper bound
    # of what any division could save
    "fastdiv": [("pcr_warp.cuh", "      if (__all_sync(kFull, ok)) {",
                 "      if (true) {"),
                ("pcr_warp.cuh",
                 "        alpha = quotient_fast(-a[r], den_lo);\n"
                 "        beta = quotient_fast(-c[r], den_hi);",
                 "        alpha = __fdividef(-a[r], den_lo);\n"
                 "        beta = __fdividef(-c[r], den_hi);")],
    # 5 or 6 blocks an SM asked of the register kernels' launch bounds
    "occ5": [("line_sweep.cu", "__launch_bounds__(32 * kRowsWarps)",
              "__launch_bounds__(32 * kRowsWarps, 5)"),
             ("line_sweep.cu", "__launch_bounds__(32 * W)",
              "__launch_bounds__(32 * W, 40 / W)")],
    "occ6": [("line_sweep.cu", "__launch_bounds__(32 * kRowsWarps)",
              "__launch_bounds__(32 * kRowsWarps, 6)"),
             ("line_sweep.cu", "__launch_bounds__(32 * W)",
              "__launch_bounds__(32 * W, 48 / W)")],
    # the passes given the line's length: range tests at run time
    "nopad": [("line_sweep.cu",
               "(ra, rb, rc, rd, 32 * R, steps, lane);",
               "(ra, rb, rc, rd, n, steps, lane);")],
}
#: variants whose results are not the twin's
INEXACT = ("nopass", "fastdiv")


def _variant(tmp: Path, name: str) -> Path:
    """Build csrc/line_sweep.cu with ``name``'s substitution; returns the
    library's path."""
    from petibm_tpu_torch import _kernels

    src = tmp / name
    shutil.copytree(_kernels._CSRC, src)
    for file, old, new in VARIANTS[name]:
        path = src / file
        text = path.read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: the source text is gone")
        path.write_text(text.replace(old, new))
    so = tmp / f"line_sweep-{name}.so"
    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS,
           *_kernels.EXTRA_FLAGS["line_sweep"], "-o", str(so),
           str(src / "line_sweep.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{proc.stderr}")
    return so


def _alternatives(plan, shape, axis, dtype):
    """(label, library, plan) of every other way to sweep the shape: the
    block path, each register row count that holds the line, and the
    shipped plan built from each source variant."""
    from petibm_tpu_torch.linalg import cuda_sweep

    n = shape[axis]
    out = []
    if plan.path != "block":
        out.append(("block", "shipped", cuda_sweep.block_plan(shape, axis)))
    path, lines = (("warp_rows", cuda_sweep.ROWS_WARPS) if axis == 2
                   else ("warp_tiles", plan.lines if plan.path == "warp_tiles"
                                         else cuda_sweep.TILE_LINES))
    if n <= cuda_sweep.WARP_LINE:
        out += [(f"R{r}", "shipped", cuda_sweep.Plan(path, r, lines))
                for r in cuda_sweep.WARP_ROWS
                if r != plan.rows and 32 * r >= n]
    if 128 < n <= 256:
        out.append(("R8", "r8", cuda_sweep.Plan(path, 8, lines)))
    if plan.path == "block":
        return out
    if plan.path == "warp_tiles":
        other = 24 - plan.lines  # the other tile width, 8 or 16
        out.append((f"W{other}", "shipped", plan._replace(lines=other)))
    if dtype.itemsize == 4:
        if plan.path == "warp_rows":
            out.append(("warps4", "warps4", plan._replace(lines=4)))
        out += [(v, v, plan) for v in ("ieeediv", "fastdiv", "occ5", "occ6")]
    return out + [(v, v, plan) for v in ("nopass", "nopad")]


def main() -> int:
    import torch

    import chip_smoke
    from petibm_tpu_torch import _kernels
    from petibm_tpu_torch.linalg import cuda_sweep
    from petibm_tpu_torch.linalg.mg import PoissonMG

    if not torch.cuda.is_available():
        raise RuntimeError("bench_torch_sweep.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"shipped": _kernels.library("line_sweep")}
        with ThreadPoolExecutor(len(VARIANTS)) as pool:
            built = pool.map(lambda v: (v, _variant(Path(tmp), v)), VARIANTS)
            for name, so in built:
                libs[name] = ctypes.CDLL(str(so))
        cases = {"450x450": chip_smoke.flagship_config(
                     os.path.join(tmp, "flagship")),
                 "sphere": chip_smoke.sphere_config(
                     os.path.join(tmp, "sphere"))}
        gen = torch.Generator(device="cuda").manual_seed(0)
        for name, cfg in cases.items():
            mesh = chip_smoke._mesh_and_bcs(cfg)[0]
            for dtype in (torch.float32, torch.float64):
                mg = PoissonMG(mesh.dxp, mesh.periodic, dtype=dtype,
                               device="cuda",
                               scale=cfg["parameters"]["dt"])
                for lvl in ((0, 1, 2) if dtype == torch.float32 else (0,)):
                    shape = tuple(mg.levels[lvl].shape)
                    phi, rhs = (torch.randn(shape, generator=gen,
                                            device="cuda", dtype=dtype)
                                for _ in range(2))
                    for d in range(mesh.dim):
                        axis = mesh.dim - 1 - d
                        aux = mg._aux(lvl, d)
                        shape3 = (1,) * (3 - phi.ndim) + shape
                        axis3 = axis + 3 - phi.ndim
                        plan = cuda_sweep.launch_plan(shape3, axis3)
                        want = cuda_sweep.fused_sweep_ref(phi, rhs, aux,
                                                          axis, 1.0)
                        for label, lib, other in _alternatives(
                                plan, shape3, axis3, dtype):
                            runs = {"plan": ("shipped", plan),
                                    label: (lib, other)}
                            times = []
                            for key in ("plan", label, label, "plan"):
                                _kernels._LIBS["line_sweep"] = libs[runs[key][0]]

                                def run(x, p=runs[key][1]):
                                    return cuda_sweep.launch(
                                        x, rhs, aux, axis, 1.0, p)

                                if key == "plan" or label not in INEXACT:
                                    err = float((run(phi) - want).abs().max())
                                    if err != 0.0:
                                        raise AssertionError(
                                            f"{key} differs: {err}")
                                times.append(chip_smoke._time_ms(
                                    run, phi, 60)[0])
                            print(f"K4/K5 {name} level {lvl} {shape} "
                                  f"direction {d} {str(dtype)[6:]} plan "
                                  f"{plan.path} R{plan.rows}: "
                                  f"{times[0] * 1e3:.2f}, "
                                  f"{times[3] * 1e3:.2f} us; {label} "
                                  f"{times[1] * 1e3:.2f}, "
                                  f"{times[2] * 1e3:.2f} us", flush=True)
                del mg
        _kernels._LIBS["line_sweep"] = libs["shipped"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
