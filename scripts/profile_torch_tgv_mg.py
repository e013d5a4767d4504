"""Device time of the 256^3 TGV's multigrid-preconditioned CG step
(``fdm: false``), kernel by kernel, over repeated profile windows.

Run on a machine with a CUDA card, from the repository root:

    python3 scripts/profile_torch_tgv_mg.py [--windows 3] [--steps 5]

Runs the cell of ``chip_smoke.py`` phase 8 for 10 steps, then profiles
``--windows`` windows of ``--steps`` more steps each with torch.profiler.
For each window it prints the wall and device ms per step, the busy
share, the p_iters of its steps, the launches of K6/K7 and the eight
device kernels with the most time (ms per step, calls per step); only
events with device type CUDA count.  Prints the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from petibm_tpu_torch.linalg import cuda_pcr
    from petibm_tpu_torch.solvers.navierstokes import NavierStokesSolver

    if not torch.cuda.is_available():
        raise RuntimeError("profile_torch_tgv_mg.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        solver = NavierStokesSolver(chip_smoke.tgv3d_config(
            os.path.join(tmp, "tgv"), nt=10, fdm=False), device="cuda")
        chip_smoke.tgv3d_initial_state(solver)
        solver.run()
        for window in range(args.windows):
            first = len(solver.stats_history)
            solver.nt += args.steps
            launches = cuda_pcr.pcr.launches
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                solver.run()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA]
            device_ms = sum(e.self_device_time_total
                            for e in events) / 1e3 / args.steps
            p_iters = [s["p_iters"] for s in solver.stats_history[first:]]
            print(f"window {window}: {wall_ms:.3f} ms/step wall, "
                  f"{device_ms:.3f} ms/step device, busy share "
                  f"{device_ms / wall_ms:.4f}; p_iters {p_iters}; K6/K7 "
                  f"launches {(cuda_pcr.pcr.launches - launches) / args.steps:.1f}"
                  "/step")
            for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
                print(f"  {e.self_device_time_total / 1e3 / args.steps:9.3f} "
                      f"ms/step {e.count / args.steps:8.1f} calls/step  "
                      f"{e.key[:90]}")
        solver.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
