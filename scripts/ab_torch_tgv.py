"""The 256^3 TGV cells of ``chip_smoke.py`` (phase 6, the FDM pressure
solve; phase 8, the multigrid-preconditioned CG one) on two checkouts of
the repository in turns on one card: ms per step, device ms per step and
the iteration counts of each.

Run on a machine with a CUDA card, from the repository root, with the
other checkout unpacked in a directory (for example ``git archive`` of
the parent commit into ``parent_check/``):

    python3 scripts/ab_torch_tgv.py --parent parent_check

Each run is a process of its own that imports ``chip_smoke`` and
``petibm_tpu_torch`` from its checkout (so each builds and runs its own
kernels), in the order parent, change, change, parent.  A run takes the
FDM cell for ``--fdm-steps`` steps and the MG-CG cell for ``--mg-steps``,
times the steps after the first (host clock, synchronised), then profiles
``--profile`` more steps with torch.profiler (device ms per step: the
device-side events only) and checks that the kinetic energy did not grow
over the run.  Prints the card's name and power limit first, a JSON line
per run, and the medians of each checkout's two runs (the MG-CG cell
also with device ms per V-cycle: its device time follows the profile
window's p_iters).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _energy(q: dict) -> float:
    return 0.5 * sum(float(a.double().pow(2).mean()) for a in q.values())


def _cell(tmp: str, fdm: bool, nsteps: int, profile_steps: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from petibm_tpu_torch.solvers.navierstokes import NavierStokesSolver

    name = "fdm" if fdm else "mg"
    params = {} if fdm else {"fdm": False}
    solver = NavierStokesSolver(chip_smoke.tgv3d_config(
        os.path.join(tmp, name), nt=1, **params), device="cuda")
    chip_smoke.tgv3d_initial_state(solver)
    energies = [_energy(solver.state["q"])]
    solver.run()
    energies.append(_energy(solver.state["q"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.nt = nsteps
    solver.run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / (nsteps - 1)
    energies.append(_energy(solver.state["q"]))
    solver.nt += profile_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solver.run()
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
    energies.append(_energy(solver.state["q"]))
    solver.close()
    hist = solver.stats_history
    if not all(s["v_ok"] and s["p_ok"] for s in hist):
        raise AssertionError(f"{name}: a solve did not converge")
    window = [s["p_iters"] for s in hist[-profile_steps:]]
    device_ms = device_us / profile_steps / 1e3
    return {"ms_step": wall * 1e3, "device_ms_step": device_ms,
            # one V-cycle per CG iteration and one more (MG-CG only)
            "window_p_iters": window,
            "device_ms_vcycle": device_ms / (statistics.mean(window) + 1),
            "v_iters": [s["v_iters"] for s in hist],
            "p_iters": [s["p_iters"] for s in hist],
            "energy": energies,
            "energy_grew": any(b > a for a, b in zip(energies, energies[1:]))}


def child(root: str, args) -> None:
    sys.path.insert(0, root)
    with tempfile.TemporaryDirectory() as tmp:
        rec = {"root": root,
               "fdm": _cell(tmp, True, args.fdm_steps, args.profile),
               "mg": _cell(tmp, False, args.mg_steps, args.profile)}
    print(json.dumps(rec), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other checkout's directory")
    ap.add_argument("--fdm-steps", type=int, default=20)
    ap.add_argument("--mg-steps", type=int, default=10)
    ap.add_argument("--profile", type=int, default=5)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child, args)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    roots = {"parent": os.path.abspath(args.parent), "change": REPO}
    runs = {"parent": [], "change": []}
    for label in ("parent", "change", "change", "parent"):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             roots[label], "--fdm-steps", str(args.fdm_steps), "--mg-steps",
             str(args.mg_steps), "--profile", str(args.profile)],
            capture_output=True, text=True, cwd=roots[label])
        if out.returncode != 0:
            raise RuntimeError(f"{label} run failed:\n{out.stderr[-4000:]}")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        runs[label].append(rec)
        print(label, json.dumps(rec), flush=True)
    for label, recs in runs.items():
        for cell in ("fdm", "mg"):
            wall = [r[cell]["ms_step"] for r in recs]
            device = [r[cell]["device_ms_step"] for r in recs]
            vcycle = [round(r[cell]["device_ms_vcycle"], 3) for r in recs]
            window = [r[cell]["window_p_iters"] for r in recs]
            print(f"{label} {cell}: ms/step {statistics.median(wall):.3f} "
                  f"(runs {wall[0]:.3f}, {wall[1]:.3f}), device ms/step "
                  f"{statistics.median(device):.3f} (runs {device[0]:.3f}, "
                  f"{device[1]:.3f}); v_iters {recs[0][cell]['v_iters']}, "
                  f"p_iters {recs[0][cell]['p_iters']}"
                  + ("" if cell == "fdm" else
                     f"; profile window p_iters {window}, device ms per "
                     f"V-cycle {vcycle}"), flush=True)
    grew = [label for label, recs in runs.items()
            if any(r[c]["energy_grew"] for r in recs for c in ("fdm", "mg"))]
    return 1 if grew else 0


if __name__ == "__main__":
    sys.exit(main())
