"""Shared CLI argument handling.

Counterpart of ``petibm_tpu/cli/common.py``: the reference's PETSc-style
flags (-directory, -config, -mesh, -flow, -parameters, -bodies, -output,
-logs; parser.cpp:175-237), single- or double-dash, -device (cuda by
default, cpu only when asked for: the counterpart of the JAX package's
``JAX_PLATFORMS``) and ``--profile-stages STEPS``, the stage profiler
run after the solve (``maybe_profile``; utils/profiling.py).
"""

from __future__ import annotations

import argparse

from ..config import load_config
from ..solvers.navierstokes import resolve_device


def make_parser(description: str,
                device: bool = True) -> argparse.ArgumentParser:
    """The reference's flags, and -device unless the tool runs on the host
    only (``device=False``)."""
    ap = argparse.ArgumentParser(description=description)
    for name in ("directory", "config", "mesh", "flow", "parameters",
                 "bodies", "probes", "output", "logs"):
        ap.add_argument(f"-{name}", f"--{name}", dest=name, default=None)
    if device:
        ap.add_argument("-device", "--device", dest="device", default="cuda",
                        help="where the fields live: cuda (default) or cpu")
        ap.add_argument("--profile-stages", dest="profile_stages", type=int,
                        default=0, metavar="STEPS",
                        help="after the run, time each solver phase over "
                             "STEPS steps and write logs/stages-<n>.txt "
                             "(the reference's PETSc log-stage dump)")
    return ap


def parse_args(description: str, argv=None, extra=None):
    """The parsed flags, ``args.device`` resolved to a ``torch.device``;
    exits with the parser's usage error when cuda is asked for (the
    default) and no card is present.  ``extra(parser)`` adds a tool's own
    flags."""
    ap = make_parser(description)
    if extra is not None:
        extra(ap)
    args = ap.parse_args(argv)
    try:
        args.device = resolve_device(args.device)
    except RuntimeError as err:
        ap.error(str(err))
    return args


def maybe_profile(solver, args) -> None:
    """Run the stage profiler when --profile-stages was given, and print
    its result (JAX cli/common.py:26-33)."""
    if getattr(args, "profile_stages", 0):
        result = solver.profile_stages(steps=args.profile_stages)
        width = max(len(k) for k in result)
        for name, ms in result.items():
            print(f"  {name:>{width}s}: {ms:8.3f} ms")


def report_chunks(solver) -> None:
    """Under stepsPerDispatch > 1, the chunks rerun because a loop
    overflowed its cap (solvers/chunk.py)."""
    if solver.steps_per_dispatch > 1:
        print(f"chunks of {solver.steps_per_dispatch} steps rerun one step "
              f"at a time after a loop overflowed its cap: "
              f"{solver.chunk_overflows}")


def config_from_args(args) -> dict:
    return load_config(
        directory=args.directory, config=args.config, mesh=args.mesh,
        flow=args.flow, parameters=args.parameters, bodies=args.bodies,
        probes=args.probes, output=args.output, logs=args.logs)
