#!/usr/bin/env python
"""Physics validation of the PyTorch/CUDA port's multigrid-preconditioned
CG pressure path on one GPU.

    python scripts/validate_torch_mgcg.py [--nt 2000] [--out DIR]

The decoupled-IBPM cylinder at Re=40 (``examples/decoupledibpm/
cylinder2dRe40``: 186^2 stretched grid, dt 0.01, float32) with
``parameters.fdm: false``, i.e. the example's own solver pair: CG +
multigrid V-cycle for the pressure (K1 as the CG operator and level-0
residual, the smoother's sweeps K4/K5), BiCGStab + Jacobi for the velocity.
Run to t = 20 through ``run()``; Cd(t = 20) against Koumoutsakos & Leonard
(1995): [1.5, 1.6] (VALIDATION.md row 1).  The same case with the direct
FDM solves runs beside it for reference (its Cd is recorded, not judged).
Then 10 more MG-CG steps are profiled (device busy share, kernels by
device time).

Writes ``torch_cylinder2dRe40_mgcg.json`` into ``--out`` (default
``validation/``) and prints it; the exit code is 0 when the MG-CG run is
inside the bracket with every solve converged.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
DEVICE = "cuda"
CASE_DIR = os.path.join(REPO, "examples", "decoupledibpm", "cylinder2dRe40")


def _config(out: str, nt: int, fdm: bool) -> dict:
    from petibm_tpu_torch.config import load_config

    cfg = load_config(directory=CASE_DIR, output=out)
    cfg["parameters"].update(nt=nt, nsave=10 ** 6, nrestart=10 ** 6,
                             dtype="float32", fdm=fdm)
    return cfg


def _run(out: str, nt: int, fdm: bool) -> tuple:
    """Run the case to ``nt`` steps; (solver, t, Cd, setup s, run s)."""
    import torch

    from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver

    t0 = time.perf_counter()
    cfg = _config(out, nt, fdm)
    solver = DecoupledIBPMSolver(cfg, device=DEVICE)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver.run()
    if solver.device.type == "cuda":
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    solver.flush_logs()
    data = np.loadtxt(os.path.join(cfg["output"], "forces-0.txt"), ndmin=2)
    return solver, data[:, 0], 2 * data[:, 1], setup_s, run_s


def main() -> int:
    from validate_torch_3d import _card, _profile

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nt", type=int, default=2000)
    ap.add_argument("--out", default=os.path.join(REPO, "validation"))
    args = ap.parse_args()
    card = _card()
    with tempfile.TemporaryDirectory() as tmp:
        solver, t, cd, setup_s, run_s = _run(os.path.join(tmp, "mg"),
                                             args.nt, fdm=False)
        hist = list(solver.stats_history)  # the profiled steps come after
        converged = all(s["v_ok"] and s["p_ok"] and s["f_ok"] for s in hist)
        p_iters = [s["p_iters"] for s in hist]
        mg = solver.poisson_mg
        levels = [list(level.shape) for level in mg.levels]
        sweeps = mg.sweeps_per_vcycle()
        profile = _profile(solver)
        solver.close()
        fdm_solver, fdm_t, fdm_cd, _, fdm_run_s = _run(
            os.path.join(tmp, "fdm"), args.nt, fdm=True)
        fdm_solver.close()
    cd_end = float(cd[-1])
    ok = converged and abs(t[-1] - 20.0) < 1e-6 and 1.5 <= cd_end <= 1.6
    result = {
        "case": "cylinder2dRe40_decoupledibpm_mgcg",
        "package": "petibm_tpu_torch", "grid": "186x186 stretched",
        "cd_at_t": {f"{tt:g}": float(np.interp(tt, t, cd))
                    for tt in (2.0, 5.0, 10.0, 20.0) if tt <= t[-1] + 1e-9},
        "cd_final": cd_end, "t_final": float(t[-1]),
        "target": "Cd(t=20) in [1.5, 1.6] (Koumoutsakos & Leonard 1995)",
        "pass": bool(ok),
        "fdm_direct_reference": {
            "cd_final": float(fdm_cd[-1]), "t_final": float(fdm_t[-1]),
            "cd_final_minus_mgcg": float(fdm_cd[-1]) - cd_end,
            "ms_per_step": fdm_run_s / len(fdm_t) * 1e3},
        "detail": {"dtype": "float32", "steps": len(hist),
                   "pressure_solve": "CG + geometric multigrid V(1,1), "
                                     "atol 1e-6 (fdm: false)",
                   "velocity_solve": "BiCGStab + Jacobi, atol 1e-6",
                   "mg_levels": levels, "sweeps_per_vcycle": sweeps,
                   "all_solves_converged": converged,
                   "p_iters_mean": statistics.mean(p_iters),
                   "p_iters_max": max(p_iters), "p_iters_last": p_iters[-1],
                   "v_iters_max": max(s["v_iters"] for s in hist),
                   "setup_s": setup_s, "run_s": run_s,
                   "ms_per_step": run_s / len(hist) * 1e3,
                   "profile": profile, **card}}
    os.makedirs(args.out, exist_ok=True)
    line = json.dumps(result)
    print(line)
    with open(os.path.join(args.out, "torch_cylinder2dRe40_mgcg.json"),
              "w") as fh:
        fh.write(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
