#!/usr/bin/env python
"""Physics validation of the PyTorch/CUDA port's 3D path on one GPU.

    python scripts/validate_torch_3d.py sphere300 [--nt 12000] [--out DIR]
    python scripts/validate_torch_3d.py tgv3d [--nt 2000] [--out DIR]

sphere300: the decoupled-IBPM sphere at Re=300 (160x130x130, the example's
1963-point body, float32) to t = 60; mean Cd and mean |Cl| over the last
30% of the run against Johnson & Patel (1999): Cd in [0.63, 0.68], Cl in
[0.04, 0.09] (VALIDATION.md row 4).

tgv3d: the Taylor-Green vortex at Re=1600 (256^3 periodic, BiCGStab +
Jacobi velocity solve, float32) to t = 20; the volume-averaged kinetic
energy every 50 steps, the dissipation -dE/dt by centred differences, and
its peak against the 2nd-order envelope of the DNS (van Rees et al. 2011):
peak in [0.010, 0.0135] at t in [8, 10] (VALIDATION.md row 10).

Both run through the solvers' ``run()`` with the hand kernels on, then
profile 10 more steps with ``torch.profiler`` (device busy share and the
kernels by device time).  Each writes its record
(``torch_sphere3dRe300.json``, ``torch_tgv3dRe1600.json``) into ``--out``
(default ``validation/``) and prints it; the exit code is 0 when the case
is inside its bracket.  The configurations are ``chip_smoke.py``'s.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
DEVICE = "cuda"


def _card() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("this validation needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}


def _profile(solver, steps: int = 10) -> dict:
    """Device busy share and the top kernels by device time over ``steps``
    more steps.  Only the device-side (kernel and memcpy) events count: the
    operators that launch them carry the same time again.  One stream, so
    the summed kernel time is the busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(evt):
        return evt.self_device_time_total

    solver.nt += steps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    busy_us = sum(device_us(e) for e in kernels)
    top = sorted(kernels, key=device_us, reverse=True)[:12]
    return {"steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
            "device_ms_per_step": busy_us / steps / 1e3,
            "device_busy_share": busy_us / wall_us,
            "top_kernels_ms_per_step": [
                [e.key[:80], device_us(e) / steps / 1e3, e.count // steps]
                for e in top]}


def case_sphere300(args, tmp: str) -> tuple[dict, bool]:
    from chip_smoke import sphere_config
    from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver

    t0 = time.perf_counter()
    cfg = sphere_config(os.path.join(tmp, "sphere"), nt=args.nt, nsave=1000)
    solver = DecoupledIBPMSolver(cfg, device=DEVICE)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver.run()
    run_s = time.perf_counter() - t0
    solver.flush_logs()
    data = np.loadtxt(os.path.join(cfg["output"], "forces-0.txt"))
    hist = list(solver.stats_history)  # the profiled steps come after
    converged = all(s["v_ok"] and s["p_ok"] and s["f_ok"] for s in hist)
    profile = _profile(solver)
    solver.close()
    area = np.pi / 4  # frontal area of the unit-diameter sphere
    t = data[:, 0]
    cd = 2 * data[:, 1] / area
    cl = 2 * np.sqrt(data[:, 2] ** 2 + data[:, 3] ** 2) / area
    sel = t >= 0.7 * t[-1]
    cd_mean, cl_mean = float(np.mean(cd[sel])), float(np.mean(cl[sel]))
    ok = converged and 0.63 <= cd_mean <= 0.68 and 0.04 <= cl_mean <= 0.09
    return {
        "case": "sphere3dRe300_decoupledibpm", "package": "petibm_tpu_torch",
        "grid": "160x130x130 stretched", "body_points": solver.bodies.n_pts,
        "cd_mean": cd_mean, "cl_mean": cl_mean, "t_final": float(t[-1]),
        "target": "mean Cd in [0.63, 0.68], mean |Cl| in [0.04, 0.09] over "
                  "the last 30% (Johnson & Patel 1999)",
        "pass": bool(ok),
        "detail": {"dtype": "float32", "steps": len(hist),
                   "all_solves_converged": converged, "setup_s": setup_s,
                   "run_s": run_s, "ms_per_step": run_s / len(hist) * 1e3,
                   "max_iters": {k: max(s[f"{k}_iters"] for s in hist)
                                 for k in "vpf"},
                   "profile": profile}}, ok


def case_tgv3d(args, tmp: str) -> tuple[dict, bool]:
    import torch

    from chip_smoke import tgv3d_config, tgv3d_initial_state
    from petibm_tpu_torch.solvers.navierstokes import NavierStokesSolver

    t0 = time.perf_counter()
    solver = NavierStokesSolver(tgv3d_config(os.path.join(tmp, "tgv"), nt=0),
                                device=DEVICE)
    tgv3d_initial_state(solver)
    setup_s = time.perf_counter() - t0

    def energy():
        return 0.5 * sum(float(q.double().pow(2).mean())
                         for q in solver.state["q"].values())

    chunk = 50
    ts, es = [0.0], [energy()]
    t0 = time.perf_counter()
    for k in range(1, args.nt // chunk + 1):
        solver.nt = k * chunk
        solver.run()
        ts.append(solver.t)
        es.append(energy())
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    hist = list(solver.stats_history)  # the profiled steps come after
    converged = all(s["v_ok"] and s["p_ok"] for s in hist)
    profile = _profile(solver)
    solver.close()
    ts, es = np.asarray(ts), np.asarray(es)
    eps = -(es[2:] - es[:-2]) / (ts[2:] - ts[:-2])
    t_eps = ts[1:-1]
    sel = (t_eps >= 6.0) & (t_eps <= 12.0)
    pk_eps = pk_t = None  # a run that ends before t = 6 has no peak
    if sel.any():
        i_pk = int(np.argmax(eps[sel]))
        pk_eps, pk_t = float(eps[sel][i_pk]), float(t_eps[sel][i_pk])
    ok = (converged and pk_eps is not None and 0.010 <= pk_eps <= 0.0135
          and 8.0 <= pk_t <= 10.0)
    return {
        "case": "taylorgreenvortex3dRe1600", "package": "petibm_tpu_torch",
        "grid": "256^3 periodic", "peak_dissipation": pk_eps,
        "peak_time": pk_t, "E0": float(es[0]), "E_final": float(es[-1]),
        "t_final": float(ts[-1]),
        "target": "peak eps = -dE/dt in [0.010, 0.0135] at t in [8, 10] "
                  "(DNS 0.0122 at t ~ 9.0; van Rees et al. 2011)",
        "pass": bool(ok),
        "detail": {"dtype": "float32", "steps": len(hist),
                   "all_solves_converged": converged, "setup_s": setup_s,
                   "run_s": run_s, "ms_per_step": run_s / len(hist) * 1e3,
                   "max_iters": {k: max(s[f"{k}_iters"] for s in hist)
                                 for k in "vp"},
                   "energy_history": [[float(a), float(b)]
                                      for a, b in zip(ts, es)],
                   "profile": profile}}, ok


#: case -> (function, default steps, record file)
CASES = {"sphere300": (case_sphere300, 12000, "torch_sphere3dRe300.json"),
         "tgv3d": (case_tgv3d, 2000, "torch_tgv3dRe1600.json")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("case", choices=sorted(CASES))
    ap.add_argument("--nt", type=int, default=None)
    ap.add_argument("--out", default=os.path.join(REPO, "validation"))
    args = ap.parse_args()
    fn, default_nt, record = CASES[args.case]
    args.nt = args.nt or default_nt
    card = _card()
    with tempfile.TemporaryDirectory() as tmp:
        result, ok = fn(args, tmp)
    result["detail"].update(card)
    os.makedirs(args.out, exist_ok=True)
    line = json.dumps(result)
    print(line)
    with open(os.path.join(args.out, record), "w") as fh:
        fh.write(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
