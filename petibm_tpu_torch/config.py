"""Configuration loading: YAML + CLI overrides + solver option files.

Mirrors the reference's capability surface (reference: src/parser/parser.cpp
:175-237 getSettings): a case directory with ``config.yaml`` whose ``mesh``,
``flow``, ``parameters``, ``bodies``, ``probes`` nodes may each be overridden
by a separate file, plus ``output``/``logs`` directory settings.  Linear
solver configs referenced from ``parameters.<name>Solver.config`` are PETSc
options files; a small subset of KSP options is understood and mapped onto
the native TPU Krylov solvers (reference: src/linsolver/linsolverksp.cpp:48-107).

Copy of ``petibm_tpu/config.py`` (held equal to the original by
tests/test_torch_host.py), except that pyyaml is imported inside
``load_config``: a solver built from a config dict never needs it.
"""

from __future__ import annotations

import os
from typing import Any


def load_config(
    directory: str | None = None,
    config: str | None = None,
    mesh: str | None = None,
    flow: str | None = None,
    parameters: str | None = None,
    bodies: str | None = None,
    probes: str | None = None,
    output: str | None = None,
    logs: str | None = None,
) -> dict:
    """Build the merged settings dict.

    Follows the reference's precedence (parser.cpp:175-237): the case
    directory defaults to cwd; the main YAML defaults to
    ``<directory>/config.yaml``; individual nodes may be overridden by
    dedicated files; ``output`` defaults to ``<directory>/output`` and
    ``logs`` to ``<output>/logs``; both directories are created.
    """
    import yaml

    directory = os.path.abspath(directory or os.getcwd())
    config_path = config or os.path.join(directory, "config.yaml")

    settings: dict[str, Any] = {"directory": directory}

    if os.path.isfile(config_path):
        with open(config_path) as fh:
            node = yaml.safe_load(fh) or {}
        settings.update(node)

    for key, path in (("mesh", mesh), ("flow", flow), ("parameters", parameters),
                      ("bodies", bodies), ("probes", probes)):
        if path is not None:
            with open(path) as fh:
                settings[key] = yaml.safe_load(fh)

    out = output or settings.get("output") or os.path.join(directory, "output")
    if not os.path.isabs(out):
        out = os.path.join(directory, out)
    settings["output"] = out

    log = logs or settings.get("logs") or os.path.join(out, "logs")
    if not os.path.isabs(log):
        log = os.path.join(directory, log)
    settings["logs"] = log

    os.makedirs(out, exist_ok=True)
    os.makedirs(log, exist_ok=True)
    return settings


_KSP_DEFAULTS = {
    "type": "cg",  # reference default KSPCG (linsolverksp.cpp:75)
    "atol": 1e-6,
    "rtol": 1e-5,
    "max_it": 10000,
    "pc": None,  # resolved per solver role in solver_config
}

# default preconditioner per solver role when neither the options file nor
# the YAML sets one: the Poisson solve wants multigrid (the reference's
# examples all use gamg/AmgX there), the others diagonal Jacobi
_DEFAULT_PC = {"poisson": "mg", "velocity": "jacobi", "forces": "jacobi"}


def _parse_amgx_options(lines: list[str]) -> dict | None:
    """Parse an AmgX key=value config (the reference's GPU solver files,
    e.g. examples/ibpm/cylinder2dRe550_GPU/config/poisson_solver.info;
    consumed by linsolveramgx.cpp:54-126) into native solver settings.

    Only the *outer* solver scope is honored (``solver(solv)=PCG`` then
    ``solv:tolerance`` / ``solv:max_iters`` / ``solv:convergence`` /
    ``solv:preconditioner``); nested scopes such as the AMG
    preconditioner's own ``prec:max_iters=1`` are correctly ignored.
    Returns None when the text is not AmgX-shaped."""
    pairs: dict[str, str] = {}
    for line in lines:
        if "=" not in line:
            continue
        key, val = line.split("=", 1)
        key = key.strip()
        # scope declarations carry the child handle: "solv:preconditioner(
        # prec)=AMG" -> normalized key "solv:preconditioner"
        if key.endswith(")") and "(" in key:
            base, handle = key[:-1].rsplit("(", 1)
            pairs[base.strip()] = val.strip()
            pairs[base.strip() + "()"] = handle.strip()
        else:
            pairs[key] = val.strip()
    outer, alg = None, None
    if "solver" in pairs:
        alg = pairs["solver"]
        outer = pairs.get("solver()")
    if alg is None:
        return None

    def get(name: str) -> str | None:
        if outer is not None and f"{outer}:{name}" in pairs:
            return pairs[f"{outer}:{name}"]
        return pairs.get(name)

    opts = dict(_KSP_DEFAULTS)
    opts["type"] = {"PCG": "cg", "CG": "cg", "PBICGSTAB": "bicgstab",
                    "BICGSTAB": "bicgstab"}.get(alg.upper(), "cg")
    tol = get("tolerance")
    if tol is not None:
        conv = (get("convergence") or "ABSOLUTE").upper()
        if conv.startswith("ABSOLUTE"):
            opts["atol"], opts["rtol"] = float(tol), 0.0
        else:  # RELATIVE_INI_CORE etc.
            opts["rtol"], opts["atol"] = float(tol), 0.0
    max_iters = get("max_iters")
    if max_iters is not None:
        opts["max_it"] = int(max_iters)
    pre = get("preconditioner")
    if pre is not None:
        opts["pc"] = {"AMG": "mg", "NOSOLVER": "none",
                      "BLOCK_JACOBI": "jacobi", "JACOBI_L1": "jacobi",
                      "MULTICOLOR_DILU": "jacobi"}.get(pre.upper(), "mg")
        opts["pc_explicit"] = True
    return opts


def parse_solver_options(path: str | None, directory: str | None = None) -> dict:
    """Parse a PETSc-style options file into native solver settings.

    Understood keys (with or without a solver prefix such as
    ``-velocity_``): ``ksp_type`` (cg | bcgs -> bicgstab), ``ksp_atol``,
    ``ksp_rtol``, ``ksp_max_it``, ``pc_type`` (none | jacobi | gamg/mg -> mg).
    Unknown options are ignored, matching the spirit of PETSc's permissive
    option handling.  AmgX ``key=value`` files (the reference's GPU cases)
    are detected and routed to ``_parse_amgx_options`` so a reference GPU
    case directory carries over with its tolerances honored.
    """
    opts = dict(_KSP_DEFAULTS)
    if not path:
        return opts
    if directory and not os.path.isabs(path):
        path = os.path.join(directory, path)
    if not os.path.isfile(path):
        return opts
    with open(path) as fh:
        raw_lines = [ln.split("#")[0].split("//")[0].strip()
                     for ln in fh]
    lines = [ln for ln in raw_lines if ln]
    if lines and not any(ln.startswith("-") for ln in lines):
        amgx = _parse_amgx_options(lines)
        if amgx is not None:
            return amgx
    with open(path) as fh:
        for raw in fh:
            line = raw.split("#")[0].split("//")[0].strip()
            if not line or not line.startswith("-"):
                continue
            parts = line.split()
            key = parts[0].lstrip("-")
            val = parts[1] if len(parts) > 1 else "true"
            # strip solver prefixes like velocity_/poisson_/forces_
            for prefix in ("velocity_", "poisson_", "forces_"):
                if key.startswith(prefix):
                    key = key[len(prefix):]
            if key == "ksp_type":
                opts["type"] = {"cg": "cg", "bcgs": "bicgstab",
                                "bicg": "bicgstab"}.get(val, val)
            elif key == "ksp_atol":
                opts["atol"] = float(val)
            elif key == "ksp_rtol":
                opts["rtol"] = float(val)
            elif key == "ksp_max_it":
                opts["max_it"] = int(val)
            elif key == "pc_type":
                opts["pc"] = {"none": "none", "jacobi": "jacobi", "gamg": "mg",
                              "mg": "mg", "hypre": "mg"}.get(val, val)
                opts["pc_explicit"] = True
    return opts


def solver_config(config: dict, name: str) -> dict:
    """Resolve ``parameters.<name>Solver`` into native solver settings.

    The reference dispatches on ``type: CPU|GPU`` to KSP vs AmgX
    (linsolver.cpp:57-91); here both run on the same backend but ``GPU``
    (AmgX) selects the reference's pinned-pressure nullspace treatment
    (navierstokes.cpp:414-420) while ``CPU`` projects out the constant
    nullspace.
    """
    params = config.get("parameters", {})
    node = params.get(f"{name}Solver", {}) or {}
    opts = parse_solver_options(node.get("config"), config.get("directory"))
    opts["backend"] = node.get("type", "CPU")
    # allow inline overrides in YAML (native extension); note node "type" is
    # the reference's CPU/GPU backend switch, so the Krylov method override
    # is spelled "kspType" here
    for key, opt in (("kspType", "type"), ("atol", "atol"), ("rtol", "rtol"),
                     ("max_it", "max_it"), ("pc", "pc"), ("dense", "dense")):
        if key in node:
            opts[opt] = node[key]
            if opt == "pc":
                opts["pc_explicit"] = True
    if opts.get("pc") is None:
        # role default, NOT a user choice: pc_explicit stays False so the
        # fast-diagonalization default can still claim the solve
        opts["pc"] = _DEFAULT_PC.get(name, "jacobi")
    return opts
