"""Fixtures of the benchmark's tests: the repository's spec, and a
throwaway benchmark root whose cells are small cuts of the two
configurations and a small Taylor-Green vortex, runnable on the CPU."""

from __future__ import annotations

import copy
import json
import math
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: the CPU cuts: the cylinder on 32 x 32 stretched cells (24 points,
#: Re 40), the sphere on 24 x 20 x 16 (100 points, Re 100); the bodyless
#: 2D Taylor-Green vortex on 32 x 32 periodic cells
SMALL2D, SMALL3D, TGV2D = "small2d", "small3d", "tgv2d"


@pytest.fixture
def cuda():
    """Skips a test where no CUDA card is present (decided here, never
    while the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def dump(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)


def _circle(n: int) -> list:
    return [[0.5 * math.cos(2 * math.pi * k / n),
             0.5 * math.sin(2 * math.pi * k / n)] for k in range(n)]


def _sphere(n: int) -> list:
    out = []
    for k in range(n):
        polar = math.acos(1.0 - 2.0 * (k + 0.5) / n)
        azim = math.pi * (1.0 + 5.0 ** 0.5) * (k + 0.5)
        out.append([0.5 * math.cos(azim) * math.sin(polar),
                    0.5 * math.sin(azim) * math.sin(polar),
                    0.5 * math.cos(polar)])
    return out


def _write_body(path: str, pts: list) -> None:
    with open(path, "w") as fh:
        fh.write(f"{len(pts)}\n")
        for p in pts:
            fh.write("\t".join(f"{v:.10e}" for v in p) + "\n")


def periodic_bcs(dim: int, walled=()) -> list:
    """Every face PERIODIC, but the axes in ``walled``: DIRICHLET, the
    upper face's u 1 (a moving lid), every other value 0."""
    out = []
    for d in range(dim):
        for side, loc in enumerate(("Minus", "Plus")):
            entry = {"location": "xyz"[d] + loc}
            for c in range(dim):
                entry["uvw"[c]] = (
                    ["DIRICHLET", 1.0 if (c == 0 and side) else 0.0]
                    if d in walled else ["PERIODIC", 0.0])
            out.append(entry)
    return out


def tgv_case(dim: int, n: int) -> dict:
    """The Taylor-Green vortex of the examples (taylorgreenvortex2dRe100,
    taylorgreenvortex3dRe1600) on n^dim periodic cells of [-pi, pi]^dim:
    its symbolic initial fields, the port's Navier-Stokes solver and the
    Navier-Stokes reference, no body; a configuration file's keys."""
    if dim == 2:
        vel = ["cos(x) * sin(y)", "- sin(x) * cos(y)"]
        p, nu = "- (cos(2*x) + cos(2*y)) / 4", 0.01
    else:
        vel = ["sin(x) * cos(y) * cos(z)", "- cos(x) * sin(y) * cos(z)", "0"]
        p, nu = "(cos(2*x) + cos(2*y)) * (cos(2*z) + 2) / 16", 0.000625
    solve = {"type": "CPU", "atol": 1e-06, "rtol": 0.0, "max_it": 10000}
    return {
        "source": "a CPU cut of the Taylor-Green vortex", "case": "tests",
        "assumed": {"dtype": "float32"}, "reduced": ["mesh"],
        "solver": "navierstokes", "reference": "navierstokes.NavierStokes",
        "inputs": {"amplitude": 0.05, "sigma": 0.6, "sites": [2] * dim,
                   "region": [[-2.0, 2.0]] * dim, "why": "tests"},
        "mesh": [{"direction": "xyz"[d], "start": -math.pi,
                  "subDomains": [{"end": math.pi, "cells": n,
                                  "stretchRatio": 1.0}]}
                 for d in range(dim)],
        "flow": {"nu": nu, "initialVelocity": vel, "initialPressure": p,
                 "boundaryConditions": periodic_bcs(dim)},
        "parameters": {"dt": 0.01, "startStep": 0, "dtype": "float32",
                       "convection": "ADAMS_BASHFORTH_2",
                       "diffusion": "CRANK_NICOLSON",
                       "velocitySolver": dict(solve),
                       "poissonSolver": dict(solve, max_it=20000)}}


def small_cases() -> dict:
    """The two cuts, as configuration files (the real files' keys)."""
    cyl = load(os.path.join(ROOT, "benchmark", "configs",
                            "cylinder2d_re200.json"))
    sph = load(os.path.join(ROOT, "benchmark", "configs",
                            "sphere3d_re300.json"))
    sub2 = [{"end": -0.6, "cells": 8, "stretchRatio": 0.95},
            {"end": 0.6, "cells": 16, "stretchRatio": 1.0},
            {"end": 2.0, "cells": 8, "stretchRatio": 1.05}]
    small2 = copy.deepcopy(cyl)
    small2.update(body=SMALL2D + ".body", reduced=["mesh", "flow", "dt"],
                  mesh=[{"direction": d, "start": -2.0, "subDomains": sub2}
                        for d in "xy"])
    small2["flow"]["nu"] = 0.025
    small2["parameters"]["dt"] = 0.005
    small2["inputs"]["region"] = [[0.6, 1.8], [-0.8, 0.8]]

    def axis(d, n_lo, n, end):
        return {"direction": d, "start": -2.0, "subDomains": [
            {"end": -0.6, "cells": n_lo, "stretchRatio": 0.9},
            {"end": 0.6, "cells": 8, "stretchRatio": 1.0},
            {"end": end, "cells": n - n_lo - 8, "stretchRatio": 1.1}]}

    small3 = copy.deepcopy(sph)
    small3.update(body=SMALL3D + ".body", reduced=["mesh", "flow", "dt"],
                  mesh=[axis("x", 7, 24, 3.0), axis("y", 6, 20, 2.0),
                        axis("z", 4, 16, 2.0)])
    small3["flow"]["nu"] = 0.01
    small3["parameters"]["dt"] = 0.01
    small3["inputs"]["region"] = [[0.6, 1.5], [-0.6, 0.6], [-0.6, 0.6]]
    return {SMALL2D: (small2, _circle(24)), SMALL3D: (small3, _sphere(100)),
            TGV2D: (tgv_case(2, 32), None)}


#: the CPU cells: (configuration, traffic, steps a chunk, solver options)
SMALL_TRAFFIC = {
    "fdm_k4": {"why": "the FDM path, 4 steps a chunk",
               "parameters": {"stepsPerDispatch": 4},
               "spinup_chunks": 1, "min_chunks": 3, "trace_chunks": 1},
    "mgcg_k2": {"why": "MG-CG, 2 steps a chunk",
                "parameters": {"stepsPerDispatch": 2, "fdm": False,
                               "velocitySolver": {"kspType": "bicgstab",
                                                  "pc": "jacobi"},
                               "poissonSolver": {"kspType": "cg",
                                                 "pc": "mg"}},
                "spinup_chunks": 1, "min_chunks": 3, "trace_chunks": 1},
}
SMALL_CELLS = {f"{SMALL2D}.fdm_k4": (SMALL2D, "fdm_k4"),
               f"{SMALL3D}.fdm_k4": (SMALL3D, "fdm_k4"),
               f"{SMALL2D}.mgcg_k2": (SMALL2D, "mgcg_k2"),
               f"{TGV2D}.fdm_k4": (TGV2D, "fdm_k4")}
#: limits for the CPU cuts (float32 against the float64 reference over a
#: few steps of a small grid)
SMALL_LIMITS = {"u_gap": 1e-4, "v_gap": 1e-4, "w_gap": 1e-4,
                "p_gap": 1e-4, "f_gap": 1e-3}


@pytest.fixture
def small_root(tmp_path):
    return make_small_root(str(tmp_path))


def make_small_root(root: str) -> str:
    """A benchmark root of its own under ``root``: the repository's
    BENCHMARK.json with the CPU cells added, their configuration, traffic
    and limit files, and a copy of the metric readers."""
    spec = load(os.path.join(ROOT, "BENCHMARK.json"))
    base = os.path.join(root, spec["paths"][0])
    shutil.copytree(os.path.join(ROOT, "benchmark", "metrics"),
                    os.path.join(base, "metrics"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, (case, pts) in small_cases().items():
        dump(os.path.join(base, "configs", name + ".json"), case)
        if pts is not None:
            _write_body(os.path.join(base, "configs", case["body"]), pts)
        spec["configs"].append({"name": name, "source": "a CPU cut",
                                "file": f"benchmark/configs/{name}.json",
                                "reduced": case["reduced"], "why": "tests"})
    for name, traffic in SMALL_TRAFFIC.items():
        dump(os.path.join(base, "traffic", name + ".json"), traffic)
    for cell, (conf, traffic) in SMALL_CELLS.items():
        dump(os.path.join(base, "limits", cell + ".json"), SMALL_LIMITS)
        spec["workloads"].append({"name": cell, "config": conf,
                                  "traffic": traffic, "chips": 1,
                                  "why": "tests"})
        for m in spec["per_layer"]:
            if m["source"] == "program_counter":
                m["workloads"].append(cell)
    dump(os.path.join(root, "BENCHMARK.json"), spec)
    return root
