"""Shared CLI argument handling.

Counterpart of ``petibm_tpu/cli/common.py``: the reference's PETSc-style
flags (-directory, -config, -mesh, -flow, -parameters, -bodies, -output,
-logs; parser.cpp:175-237), single- or double-dash, and -device (cuda by
default, cpu only when asked for: the counterpart of the JAX package's
``JAX_PLATFORMS``).  The stage profiler flag waits for ROADMAP item 17.
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
    return ap


def parse_args(description: str, argv=None):
    """The parsed flags, ``args.device`` resolved to a ``torch.device``;
    exits with the parser's usage error when cuda is asked for (the
    default) and no card is present."""
    ap = make_parser(description)
    args = ap.parse_args(argv)
    try:
        args.device = resolve_device(args.device)
    except RuntimeError as err:
        ap.error(str(err))
    return args


def config_from_args(args) -> dict:
    return load_config(
        directory=args.directory, config=args.config, mesh=args.mesh,
        flow=args.flow, parameters=args.parameters, bodies=args.bodies,
        probes=args.probes, output=args.output, logs=args.logs)
