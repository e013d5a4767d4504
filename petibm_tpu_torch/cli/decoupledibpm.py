"""petibm-decoupledibpm on PyTorch (counterpart of
``petibm_tpu/cli/decoupledibpm.py``; reference:
applications/decoupledibpm/main.cpp).

    python -m petibm_tpu_torch.cli.decoupledibpm -directory <case>
"""

from __future__ import annotations

import sys

from ..solvers.decoupledibpm import DecoupledIBPMSolver
from .common import (config_from_args, maybe_profile, parse_args,
                     report_chunks)


def main(argv=None) -> int:
    args = parse_args(
        "Decoupled IBPM solver (Li et al. 2016), PyTorch/CUDA port", argv)
    config = config_from_args(args)
    solver = DecoupledIBPMSolver(config, device=args.device)
    print(solver.mesh.info())
    print(f"device: {solver.device}, dtype: {solver.dtype}")
    print(f"bodies: {solver.bodies.n_bodies} ({solver.bodies.n_pts} points)")
    solver.run(progress=True)
    maybe_profile(solver, args)
    solver.close()
    report_chunks(solver)
    print(solver.timers.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
