"""Shared CLI argument handling.

Counterpart of ``petibm_tpu/cli/common.py``: the reference's PETSc-style
flags (-directory, -config, -mesh, -flow, -parameters, -bodies, -output,
-logs; parser.cpp:175-237), single- or double-dash.  The stage profiler
flag waits for ROADMAP item 17.
"""

from __future__ import annotations

import argparse

from ..config import load_config


def make_parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    for name in ("directory", "config", "mesh", "flow", "parameters",
                 "bodies", "probes", "output", "logs"):
        ap.add_argument(f"-{name}", f"--{name}", dest=name, default=None)
    return ap


def config_from_args(args) -> dict:
    return load_config(
        directory=args.directory, config=args.config, mesh=args.mesh,
        flow=args.flow, parameters=args.parameters, bodies=args.bodies,
        probes=args.probes, output=args.output, logs=args.logs)
