"""The decoupled IBPM with prescribed body kinematics on PyTorch
(counterpart of ``petibm_tpu/cli/rigidkinematics.py``; the reference ships
RigidKinematicsSolver as an extension point, applications/rigidkinematics).
The built-in ``kinematics:`` node of a body runs without user code; other
motions subclass ``RigidKinematicsSolver``.

    python -m petibm_tpu_torch.cli.rigidkinematics -directory <case>
"""

from __future__ import annotations

import sys

from ..solvers.rigidkinematics import RigidKinematicsSolver
from .common import (config_from_args, maybe_profile, parse_args,
                     report_chunks)


def main(argv=None) -> int:
    args = parse_args("Decoupled IBPM with prescribed body kinematics, "
                      "PyTorch/CUDA port", argv)
    config = config_from_args(args)
    solver = RigidKinematicsSolver(config, device=args.device)
    print(solver.mesh.info())
    print(f"device: {solver.device}, dtype: {solver.dtype}")
    print(f"bodies: {solver.bodies.n_bodies} ({solver.bodies.n_pts} points)")
    solver.run(progress=True)
    maybe_profile(solver, args)
    solver.close()
    report_chunks(solver)
    print(f"force solves that fell back to the dense solve: "
          f"{solver.fallbacks}")
    print(solver.timers.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
