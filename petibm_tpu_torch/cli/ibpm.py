"""petibm-ibpm on PyTorch (counterpart of ``petibm_tpu/cli/ibpm.py``;
reference: applications/ibpm/main.cpp).

    python -m petibm_tpu_torch.cli.ibpm -directory <case>
"""

from __future__ import annotations

import sys

from ..parallel.multihost import shutdown
from ..solvers.ibpm import IBPMSolver
from .common import (config_from_args, maybe_profile, parse_args,
                     report_chunks)


def main(argv=None) -> int:
    args = parse_args("IBPM solver (Taira & Colonius 2007), PyTorch/CUDA "
                      "port", argv)
    config = config_from_args(args)
    solver = IBPMSolver(config, device=args.device)
    print(solver.mesh.info())
    print(f"device: {solver.device}, dtype: {solver.dtype}")
    print(f"bodies: {solver.bodies.n_bodies} ({solver.bodies.n_pts} points)")
    solver.run(progress=True)
    maybe_profile(solver, args)
    solver.close()
    shutdown()
    report_chunks(solver)
    print(solver.timers.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
