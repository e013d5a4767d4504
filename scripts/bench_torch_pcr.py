"""K6/K7 (csrc/tridiag_pcr.cu) at the TGV's finest multigrid level, 256^3,
against variants of its own source, to show what bounds it.

Run on a machine with a CUDA card, from the repository root:

    python3 scripts/bench_torch_pcr.py

Each variant is the shipped source with one text substitution, built from
a copy under a temporary directory:

- ``nopass``: the PCR passes compiled out (the kernel loads, divides d by
  b and stores), which splits the time of the loads and stores from the
  time of the passes (the compiler may drop the loads of a and c where
  nothing reads them);
- ``nofull``: lines that fill the warp (n = 32 R) get no compile-time
  specialisation;
- ``tile16``: 16 lines a ``warp_tiles`` block (16 warps, rows of 64 bytes
  in float32) instead of 8;
- ``exactdiv``: the register passes' float32 quotients by K4/K5's
  ``quotient_fast``/``quotient_scaled`` (``ExactDiv`` in csrc/pcr_warp.cuh)
  instead of `/` (float64 divides by `/` either way).

For each variant, dtype and axis the shipped kernel and the variant are
timed in turns (shipped, variant, variant, shipped; median device time
per apply, CUDA events).  Prints the card's name and power limit first.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

#: name: (file of csrc/, the line replaced, its replacement)
VARIANTS = {
    "nopass": ("pcr_warp.cuh",
               "    if (S >= steps) return;  // the same for every lane of the warp",
               "    return;"),
    "nofull": ("tridiag_pcr.cu", "  if (g.n == 32 * R)\n", "  if (false)\n"),
    "tile16": ("tridiag_pcr.cu", "constexpr int kTileLines = 8;",
               "constexpr int kTileLines = 16;"),
    "exactdiv": ("pcr_warp.cuh", "int S, bool ExactDiv = false>",
                 "int S, bool ExactDiv = true>"),
}


def _variant_library(tmp: Path, name: str):
    """The loaded library of csrc/tridiag_pcr.cu with ``name``'s
    substitution."""
    from petibm_tpu_torch import _kernels

    src = tmp / name
    shutil.copytree(_kernels._CSRC, src)
    file, old, new = VARIANTS[name]
    path = src / file
    text = path.read_text()
    if text.count(old) != 1:
        raise RuntimeError(f"variant {name}: the source line is gone")
    path.write_text(text.replace(old, new))
    shipped = _kernels._CSRC
    _kernels._CSRC = src
    try:
        _kernels._LIBS.pop("tridiag_pcr", None)
        return _kernels.library("tridiag_pcr")
    finally:
        _kernels._CSRC = shipped
        _kernels._LIBS.pop("tridiag_pcr", None)


def main() -> int:
    import torch

    import chip_smoke
    from petibm_tpu_torch import _kernels
    from petibm_tpu_torch.linalg import cuda_pcr
    from petibm_tpu_torch.linalg.mg import PoissonMG

    if not torch.cuda.is_available():
        raise RuntimeError("bench_torch_pcr.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"shipped": _kernels.library("tridiag_pcr")}
        for name in VARIANTS:
            libs[name] = _variant_library(Path(tmp), name)
        mesh = chip_smoke._mesh_and_bcs(chip_smoke.tgv3d_config(
            os.path.join(tmp, "tgv")))[0]
        for dtype in (torch.float32, torch.float64):
            mg = PoissonMG(mesh.dxp, mesh.periodic, dtype=dtype,
                           device="cuda", scale=0.01)
            gen = torch.Generator(device="cuda").manual_seed(0)
            rhs = torch.randn(tuple(mg.levels[0].shape), generator=gen,
                              device="cuda", dtype=dtype)
            for axis in (2, 1, 0):
                dl, diag, du = mg._line_system(0, 2 - axis)
                plan = cuda_pcr.launch_plan(rhs.shape, axis)
                want = cuda_pcr.pcr_ref(dl, diag, du, rhs, axis)
                for name in VARIANTS:
                    if name == "tile16" and axis == 2:
                        continue
                    plans = {"shipped": plan, name: plan._replace(
                        lines=16) if name == "tile16" else plan}
                    times = []
                    for lib in ("shipped", name, name, "shipped"):
                        _kernels._LIBS["tridiag_pcr"] = libs[lib]

                        def run(x, p=plans[lib]):
                            return cuda_pcr.launch(dl, diag, du, x, axis, p)

                        if lib == "shipped" or name != "nopass":
                            err = float((run(rhs) - want).abs().max())
                            if err != 0.0:
                                raise AssertionError(f"{lib} differs: {err}")
                        times.append(chip_smoke._time_ms(run, rhs, 60)[0])
                    print(f"K6/K7 256^3 {str(dtype)[6:]} axis {axis} "
                          f"{plan.path}: shipped {times[0] * 1e3:.2f}, "
                          f"{times[3] * 1e3:.2f} us; {name} "
                          f"{times[1] * 1e3:.2f}, {times[2] * 1e3:.2f} us",
                          flush=True)
            del mg, dl, diag, du
        _kernels._LIBS["tridiag_pcr"] = libs["shipped"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
