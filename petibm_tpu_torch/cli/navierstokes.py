"""petibm-navierstokes on PyTorch (counterpart of
``petibm_tpu/cli/navierstokes.py``; reference:
applications/navierstokes/main.cpp:45-78).

    python -m petibm_tpu_torch.cli.navierstokes -directory <case>
"""

from __future__ import annotations

import sys

from ..parallel.multihost import shutdown
from ..solvers.navierstokes import NavierStokesSolver
from .common import (config_from_args, maybe_profile, parse_args,
                     report_chunks)


def main(argv=None) -> int:
    args = parse_args("Navier-Stokes projection solver, PyTorch/CUDA port",
                      argv)
    config = config_from_args(args)
    solver = NavierStokesSolver(config, device=args.device)
    print(solver.mesh.info())
    print(f"device: {solver.device}, dtype: {solver.dtype}")
    solver.run(progress=True)
    maybe_profile(solver, args)
    solver.close()
    shutdown()
    report_chunks(solver)
    print(solver.timers.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
