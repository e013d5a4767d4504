#!/usr/bin/env python
"""Physics validation of the PyTorch/CUDA port's moving bodies on one GPU.

    python scripts/validate_torch_oscillating.py [--dtype float32,float64]
        [--nt 10000] [--out DIR]

``examples/decoupledibpm/oscillatingcylinder2dRe100`` (512^2 uniform, the
157-point cylinder oscillating in line at KC = 5, Re = 100, the
PESKIN_2002 delta, dt 0.002; ``chip_smoke.oscillating_config``) through
``RigidKinematicsSolver.run()`` for ``--nt`` steps (10000: four periods).
The in-line force of the last two periods is fitted to Morison's
equation, after the force of the fluid inside the body is taken out (the
fit of ``scripts/validate_forces.py``'s oscillating case, copied):
CD in [1.85, 2.35] and CM in [1.2, 1.7] pass (Dutsch et al. 1998: CD ~
2.09, CM ~ 1.45; VALIDATION.md row 3).  Each run then profiles 10 more
steps (device busy share, kernels by device time).

Writes ``torch_oscillating_<dtype>.json`` into ``--out`` (default
``validation/``) and prints it: the card's name and power limit, setup
seconds, ms/step over steps 1001 to the end, the force solve's fallbacks
to the dense solve and its mean refinement passes (``f_iters``).  The
exit code is 0 when every run is in the band with every solve converged.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

#: the example's kinematics: x(t) = -Am sin(2 pi f t), Am = D KC / 2 pi
F, D, KC = 0.2, 1.0, 5.0
CD_BAND, CM_BAND = (1.85, 2.35), (1.2, 1.7)


def morison_fit(t, fx) -> tuple:
    """(CD, CM) of Fx(t) = -1/2 CD D |u| u - CM rho pi D^2/4 du/dt over the
    last two periods, u(t) = -Um cos(2 pi f t) the cylinder's velocity;
    rho V a_body is added first: the Lagrangian force sum includes
    accelerating the fluid inside the body (the reference's own
    post-processing does the same, plotDragCoefficient.py:31-33)."""
    import numpy as np

    um = KC * F * D
    sel = t >= t[-1] - 2.0 / F
    ts, fs = t[sel], fx[sel]
    u = -um * np.cos(2 * np.pi * F * ts)
    dudt = um * 2 * np.pi * F * np.sin(2 * np.pi * F * ts)
    fs = fs + np.pi * D**2 / 4 * dudt
    basis = np.stack([-0.5 * D * np.abs(u) * u,
                      -np.pi * D**2 / 4 * dudt], axis=1)
    (cd_fit, cm_fit), *_ = np.linalg.lstsq(basis, fs, rcond=None)
    return float(cd_fit), float(cm_fit)


def run(tmp: str, dtype: str, nt: int, warm: int = 1000) -> dict:
    import numpy as np
    import torch

    import chip_smoke
    from petibm_tpu_torch.solvers.rigidkinematics import RigidKinematicsSolver
    from validate_torch_3d import _profile

    t0 = time.perf_counter()
    solver = RigidKinematicsSolver(chip_smoke.oscillating_config(
        os.path.join(tmp, dtype), nt=nt, dtype=dtype), device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    elapsed = chip_smoke._timed_run(solver, warm, nt)
    hist = solver.stats_history
    converged = all(s[f"{k}_ok"] for s in hist for k in "vpf")
    forces = np.loadtxt(os.path.join(solver.output_dir, "forces-0.txt"),
                        ndmin=2)
    cd, cm = morison_fit(forces[:, 0], forces[:, 1])
    f_iters = [s["f_iters"] for s in hist]
    record = {
        "case": "oscillatingcylinder2dRe100", "solver": "RigidKinematicsSolver",
        "package": "petibm_tpu_torch",
        "grid": "x".join(str(n) for n in solver.mesh.shape(3)),
        "body_points": solver.bodies.n_pts, "dtype": dtype,
        "steps": len(hist), "t_final": float(forces[-1, 0]),
        "cd_morison": cd, "cm_morison": cm,
        "target": "CD ~ 2.09, CM ~ 1.45 (Dutsch et al. 1998, Re=100 KC=5); "
                  f"band CD {list(CD_BAND)}, CM {list(CM_BAND)}",
        "all_solves_converged": converged,
        "pass": bool(converged and CD_BAND[0] <= cd <= CD_BAND[1]
                     and CM_BAND[0] <= cm <= CM_BAND[1]),
        "setup_s": setup_s,
        "ms_per_step": elapsed / (nt - warm) * 1e3,
        "timed_steps": [warm + 1, nt],
        "run_s": elapsed,
        "fallbacks": solver.fallbacks,
        "f_iters_mean": statistics.mean(f_iters), "f_iters_max": max(f_iters),
        "p_iters_mean": statistics.mean(s["p_iters"] for s in hist),
        "v_iters_mean": statistics.mean(s["v_iters"] for s in hist),
    }
    record["profile"] = _profile(solver)
    solver.close()
    return record


def main() -> int:
    from validate_torch_3d import _card

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="float32",
                    help="comma-separated: float32, float64")
    ap.add_argument("--nt", type=int, default=10000)
    ap.add_argument("--out", default=os.path.join(REPO, "validation"))
    args = ap.parse_args()
    card = _card()
    ok = True
    os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in args.dtype.split(","):
            record = run(tmp, dtype, args.nt)
            record.update(card)
            ok = ok and record["pass"]
            line = json.dumps(record)
            print(line, flush=True)
            with open(os.path.join(args.out, f"torch_oscillating_{dtype}.json"),
                      "w") as fh:
                fh.write(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
