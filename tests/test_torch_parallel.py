"""The port's domain decomposition (``petibm_tpu_torch/parallel/``) on CPU
processes over gloo, held to the JAX package.

Twins of ``tests/test_parallel.py`` and ``tests/test_multihost.py``: the
ranks are processes of this file (``python test_torch_parallel.py <job>
<rank> <world> <port> <out>``, one torch thread each), started once by a
module fixture (``RankJob``).  Rank 0 publishes each result in ``<out>``
as soon as it is known (the layout and FDM checks, then each case's
fields gathered and stats per step), and each test waits for the one file
it reads, so a slow or failed case fails its own tests.  The job's time
limit guards against a hang, not against a slow machine.  The tests run
the JAX package's single-device solver in this process on the same
configurations.

- job ``four`` (4 ranks): ``mesh_from_config`` (a 3-axis shape among
  them); scatter, gather and the
  halo on staggered, uneven, periodic and walled blocks on [2, 2], [1, 4]
  and [4, 1]; the decomposed FDM Poisson and Helmholtz solves against
  the single-rank solves (2D stretched, 3D with a periodic z by FFT, odd
  sizes, FFTs on decomposed axes); the cavity, the 2D cylinder, the 3D
  sphere, a 16^3 TGV (BiCGStab + Jacobi momentum solve), and the pinned
  pressure on the cavity and a periodic TGV2D, on [2, 2];
- the V-cycle, the coupled IBPM and the moving body decomposed:
  ``test_torch_parallel_mg.py``; the 3-axis mesh, ``fdm.repartition:
  false``, the windowed engine and the probes:
  ``test_torch_parallel_3axis.py``; chunks of steps
  (``stepsPerDispatch``) on the ranks: ``test_torch_parallel_chunked.py``;
- the navierstokes CLI under ``torch.distributed.run`` on 2 processes
  against a single-process run: logs and rank 0's snapshot.
"""

from __future__ import annotations

import datetime
import json
import math
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

SHARDING = {"platform": "cpu"}
MESH_SHAPES = ([2, 2], [1, 4], [4, 1])
#: the job's time limit (s from its start): a guard against a hang, at
#: least 4x the job's run on an idle machine (CHANGES.md), not a speed check
TIMEOUT = 240
#: how long a rank waits in one collective before it fails with an error
#: (``init_process_group``'s timeout): a deadlock ends the ranks
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=180)


# --- configurations (twins of tests/test_parallel.py's) ---------------------
def cavity_config(tmpdir, n=16, sharding=None):
    params = {
        "dt": 0.01, "nt": 10, "nsave": 10, "nrestart": 10,
        "dtype": "float64",
        "convection": "ADAMS_BASHFORTH_2", "diffusion": "CRANK_NICOLSON",
        "velocitySolver": {"type": "CPU", "atol": 1e-12, "rtol": 0.0,
                           "max_it": 200},
        "poissonSolver": {"type": "CPU", "atol": 1e-12, "rtol": 0.0,
                          "max_it": 500},
    }
    if sharding:
        params["sharding"] = sharding
    return {
        "directory": str(tmpdir),
        "output": os.path.join(str(tmpdir), "output"),
        "logs": os.path.join(str(tmpdir), "logs"),
        "mesh": [
            {"direction": "x", "start": 0.0,
             "subDomains": [{"end": 1.0, "cells": n, "stretchRatio": 1.0}]},
            {"direction": "y", "start": 0.0,
             "subDomains": [{"end": 1.0, "cells": n, "stretchRatio": 1.05}]},
        ],
        "flow": {
            "nu": 0.01,
            "initialVelocity": [0.0, 0.0],
            "boundaryConditions": [
                {"location": "xMinus", "u": ["DIRICHLET", 0.0],
                 "v": ["DIRICHLET", 0.0]},
                {"location": "xPlus", "u": ["DIRICHLET", 0.0],
                 "v": ["DIRICHLET", 0.0]},
                {"location": "yMinus", "u": ["DIRICHLET", 0.0],
                 "v": ["DIRICHLET", 0.0]},
                {"location": "yPlus", "u": ["DIRICHLET", 1.0],
                 "v": ["DIRICHLET", 0.0]},
            ],
        },
        "parameters": params,
    }


def cylinder_config(tmpdir, sharding=None):
    n = 24
    os.makedirs(str(tmpdir), exist_ok=True)
    path = os.path.join(str(tmpdir), "circle.body")
    with open(path, "w") as fh:
        fh.write(f"{n}\n")
        for k in range(n):
            th = 2 * math.pi * k / n
            fh.write(f"{0.5 * math.cos(th):.8e}\t{0.5 * math.sin(th):.8e}\n")
    cfg = cavity_config(tmpdir, n=32, sharding=sharding)
    cfg["mesh"] = [
        {"direction": d, "start": -2.0,
         "subDomains": [{"end": 2.0, "cells": 32, "stretchRatio": 1.0}]}
        for d in ("x", "y")
    ]
    cfg["flow"] = {
        "nu": 0.025,
        "initialVelocity": [1.0, 0.0],
        "boundaryConditions": [
            {"location": "xMinus", "u": ["DIRICHLET", 1.0],
             "v": ["DIRICHLET", 0.0]},
            {"location": "xPlus", "u": ["CONVECTIVE", 1.0],
             "v": ["CONVECTIVE", 1.0]},
            {"location": "yMinus", "u": ["DIRICHLET", 1.0],
             "v": ["DIRICHLET", 0.0]},
            {"location": "yPlus", "u": ["DIRICHLET", 1.0],
             "v": ["DIRICHLET", 0.0]},
        ],
    }
    cfg["parameters"]["dt"] = 0.005
    cfg["parameters"]["forcesSolver"] = {"type": "CPU", "atol": 1e-12,
                                         "rtol": 0.0, "max_it": 200}
    cfg["bodies"] = [{"type": "points", "file": path}]
    return cfg


def make_sphere_file(directory, r=0.15, center=(0.5, 0.5, 0.5)):
    """The Fibonacci-lattice sphere of tests/test_ibm.py (40 points)."""
    n = 40
    k = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * k / n)
    theta = np.pi * (1 + np.sqrt(5.0)) * k
    pts = np.stack([center[0] + r * np.sin(phi) * np.cos(theta),
                    center[1] + r * np.sin(phi) * np.sin(theta),
                    center[2] + r * np.cos(phi)], axis=1)
    os.makedirs(str(directory), exist_ok=True)
    path = os.path.join(str(directory), "sphere.body")
    with open(path, "w") as fh:
        fh.write(f"{n}\n")
        for p in pts:
            fh.write(f"{p[0]:.10e}\t{p[1]:.10e}\t{p[2]:.10e}\n")
    return path


def sphere_config(tmpdir, sharding=None):
    n = 16
    cfg = cavity_config(tmpdir, n=n, sharding=sharding)
    cfg["mesh"] = [
        {"direction": d, "start": 0.0,
         "subDomains": [{"end": 1.0, "cells": n, "stretchRatio": 1.0}]}
        for d in ("x", "y", "z")
    ]
    bcs = []
    for loc in ("xMinus", "yMinus", "yPlus", "zMinus", "zPlus"):
        bcs.append({"location": loc, "u": ["DIRICHLET", 1.0],
                    "v": ["DIRICHLET", 0.0], "w": ["DIRICHLET", 0.0]})
    bcs.append({"location": "xPlus", "u": ["CONVECTIVE", 1.0],
                "v": ["CONVECTIVE", 1.0], "w": ["CONVECTIVE", 1.0]})
    cfg["flow"] = {"nu": 0.02, "initialVelocity": [1.0, 0.0, 0.0],
                   "boundaryConditions": bcs}
    cfg["parameters"]["dt"] = 0.005
    cfg["parameters"]["forcesSolver"] = {"type": "CPU", "atol": 1e-12,
                                         "rtol": 0.0, "max_it": 200}
    cfg["bodies"] = [{"type": "points", "file": make_sphere_file(tmpdir)}]
    return cfg


def tgv_config(tmpdir, sharding=None):
    """tests/test_torch_tgv3d.py's 16^3 TGV: BiCGStab with the probed
    Jacobi diagonal for the momentum, the FDM pressure."""
    pi = math.pi
    solver = {"type": "CPU", "atol": 1e-6, "rtol": 0.0}
    params = {"dt": 0.05, "nt": 5, "nsave": 100, "nrestart": 100,
              "dtype": "float64", "fdm": {"velocity": False},
              "convection": "ADAMS_BASHFORTH_2",
              "diffusion": "CRANK_NICOLSON",
              "velocitySolver": dict(solver, kspType="bicgstab"),
              "poissonSolver": dict(solver)}
    if sharding:
        params["sharding"] = sharding
    return {
        "directory": str(tmpdir),
        "output": os.path.join(str(tmpdir), "output"),
        "logs": os.path.join(str(tmpdir), "logs"),
        "mesh": [{"direction": ax, "start": -pi, "subDomains": [
            {"end": pi, "cells": 16, "stretchRatio": 1.0}]} for ax in "xyz"],
        "flow": {"nu": 0.000625,
                 "initialVelocity": ["sin(x) * cos(y) * cos(z)",
                                     "- cos(x) * sin(y) * cos(z)", "0"],
                 "initialPressure":
                     "(cos(2*x) + cos(2*y)) * (cos(2*z) + 2) / 16",
                 "boundaryConditions": [
                     {"location": ax + side,
                      **{f: ["PERIODIC", 0.0] for f in "uvw"}}
                     for ax in "xyz" for side in ("Minus", "Plus")]},
        "parameters": params,
    }


def cavity_pinned_config(tmpdir, sharding=None):
    """The cavity with the pinned pressure (``poissonSolver.type: GPU``):
    entry 0 on one rank, the FDM solve projected (tests/test_torch_pinned
    .py)."""
    cfg = cavity_config(tmpdir, sharding=sharding)
    cfg["parameters"]["poissonSolver"]["type"] = "GPU"
    return cfg


def tgv2d_pinned_config(tmpdir, sharding=None):
    """examples/navierstokes/taylorgreenvortex2dRe100 cut to 32^2 with the
    pinned pressure (tests/test_torch_pinned.py): periodic on both axes,
    so the pinned FDM solve takes its FFTs on the decomposed x and y;
    BiCGStab + Jacobi velocity."""
    from petibm_tpu_torch.config import load_config

    cfg = load_config(directory=os.path.join(
        REPO, "examples", "navierstokes", "taylorgreenvortex2dRe100"))
    cfg["output"] = os.path.join(str(tmpdir), "output")
    cfg["logs"] = os.path.join(str(tmpdir), "logs")
    for axis in cfg["mesh"]:
        axis["subDomains"][0]["cells"] = 32
    cfg["parameters"].update(dtype="float64", nt=10)
    cfg["parameters"]["poissonSolver"]["type"] = "GPU"
    if sharding:
        cfg["parameters"]["sharding"] = sharding
    return cfg


#: name -> (config function, solver module.class, steps, atol); the JAX
#: package's bounds (tests/test_parallel.py:108-193)
CASES = {
    "cavity": (cavity_config, "navierstokes.NavierStokesSolver", 10, 1e-10),
    "cylinder": (cylinder_config, "decoupledibpm.DecoupledIBPMSolver", 5,
                 1e-9),
    "sphere": (sphere_config, "decoupledibpm.DecoupledIBPMSolver", 3, 1e-9),
    "tgv_bicgstab": (tgv_config, "navierstokes.NavierStokesSolver", 5,
                     1e-9),
    "cavity_pinned": (cavity_pinned_config,
                      "navierstokes.NavierStokesSolver", 10, 1e-10),
    "tgv2d_pinned": (tgv2d_pinned_config, "navierstokes.NavierStokesSolver",
                     10, 1e-9),
}


def _solver_class(name: str, package: str):
    import importlib

    module, cls = name.split(".")
    return getattr(importlib.import_module(f"{package}.solvers.{module}"),
                   cls)


# --- grids of the layout and FDM checks -----------------------------------
def _axis(d, n, ratio=1.0, end=1.0):
    return {"direction": d, "start": 0.0,
            "subDomains": [{"end": end, "cells": n, "stretchRatio": ratio}]}


def _grid(axes, periodic=""):
    """A mesh config: ``axes`` (direction, cells, stretch ratio), the
    directions in ``periodic`` periodic, the others walls."""
    bcs = []
    names = "uvw"[:len(axes)]
    for d, _, _ in axes:
        kind = "PERIODIC" if d in periodic else "DIRICHLET"
        for side in ("Minus", "Plus"):
            bcs.append({"location": d + side,
                        **{f: [kind, 0.0] for f in names}})
    return {"mesh": [_axis(d, n, r) for d, n, r in axes],
            "flow": {"nu": 0.01, "boundaryConditions": bcs}}


LAYOUT_GRIDS = {
    "walls_2d": _grid([("x", 11, 1.0), ("y", 9, 1.0)]),
    "periodic_x_2d": _grid([("x", 10, 1.0), ("y", 13, 1.0)], "x"),
    "periodic_xy_2d": _grid([("x", 9, 1.0), ("y", 8, 1.0)], "xy"),
    "periodic_y_3d": _grid([("x", 9, 1.0), ("y", 10, 1.0), ("z", 5, 1.0)],
                           "y"),
}

#: the FDM's grids: every periodic axis is uniform, so it takes the FFT
FDM_GRIDS = {
    "stretched_2d": _grid([("x", 13, 1.07), ("y", 11, 0.95)]),
    "fft_z_3d": _grid([("x", 9, 1.05), ("y", 10, 0.97), ("z", 8, 1.0)],
                      "z"),
    "fft_xy_2d": _grid([("x", 9, 1.0), ("y", 10, 1.0)], "xy"),
    "fft_y_2d": _grid([("x", 11, 1.06), ("y", 9, 1.0)], "y"),
    "fft_xyz_3d": _grid([("x", 8, 1.0), ("y", 9, 1.0), ("z", 6, 1.0)],
                        "xyz"),
}

# --- the rank processes ----------------------------------------------------
def _layout_checks(part, mesh, seed):
    """Scatter -> gather round trips and the halo of every field and
    direction against the full array: {check: worst |error|}."""
    from petibm_tpu_torch.types import Field

    rng = np.random.default_rng(seed)
    worst = {"gather": 0.0, "halo": 0.0, "face": 0.0}
    for field in [Field(c) for c in range(mesh.dim)] + [Field.P]:
        full = torch.as_tensor(rng.standard_normal(mesh.shape(field)))
        loc = part.scatter(full, field)
        back = part.gather(loc, field)
        worst["gather"] = max(worst["gather"],
                              float((back - full).abs().max()))
        for d in range(mesh.dim):
            axis = mesh.dim - 1 - d
            n = full.shape[axis]
            lo, hi = part.range(field, d)
            blk = list(part.block(field))
            wrap = part.periodic[d]
            want = []
            for idx in (lo - 1 if lo > 0 else (n - 1 if wrap else None),
                        hi if hi < n else (0 if wrap else None)):
                if idx is None:
                    want.append(None)
                    continue
                sl = list(blk)
                sl[axis] = slice(idx, idx + 1)
                want.append(full[tuple(sl)])
            # both slabs, then the upper one alone (``extend_hi``)
            got = part.halo(loc, d) + part.halo(loc, d, lower=False)
            for g, w in zip(got, want + [None, want[1]]):
                if (g is None) != (w is None):
                    worst["halo"] = math.inf
                elif g is not None:
                    worst["halo"] = max(worst["halo"],
                                        float((g - w).abs().max()))
            # a face's segments assembled from the ranks on it
            for side in (0, 1):
                face = full.select(axis, n - 1 if side else 0)
                seg = part.scatter_face(face, field, d)
                got_face = part.gather_face(seg, field, d, side)
                worst["face"] = max(worst["face"],
                                    float((got_face - face).abs().max()))
    return worst


def _fdm_checks(part, mesh, cfg, seed, repartition=True):
    """Each decomposed FDM solve against the single-rank solve on the same
    right side: {solve: max |difference| / max |x|}; ``repartition``
    false asks for the contraction core."""
    from petibm_tpu_torch.boundary import BoundarySet
    from petibm_tpu_torch.linalg.fdm import (FastDiagHelmholtz,
                                             FastDiagPoisson,
                                             helmholtz_lines)
    from petibm_tpu_torch.types import Field

    rng = np.random.default_rng(seed)
    kw = dict(dtype=torch.float64, device="cpu")
    fft = any(mesh.periodic)
    out = {}
    solvers = {"poisson": (Field.P, lambda: FastDiagPoisson(
        mesh.dxp, mesh.periodic, scale=0.01, use_fft=fft, **kw))}
    bc = BoundarySet(mesh, cfg)
    for c in range(mesh.dim):
        solvers[f"helmholtz_{'uvw'[c]}"] = (
            Field(c), lambda c=c: FastDiagHelmholtz(
                helmholtz_lines(mesh, bc, c), 0.01, 0.005, use_fft=fft,
                **kw))
    for name, (field, make) in solvers.items():
        b = torch.as_tensor(rng.standard_normal(mesh.shape(field)))
        single = make()
        want = single.solve(b)
        dec = make()
        if field == Field.P:
            dec.set_mesh(part, repartition=repartition)
        else:
            dec.set_mesh(part, field, repartition=repartition)
        assert set(dec._fft_axes) == {mesh.dim - 1 - d for d in
                                      range(mesh.dim) if mesh.periodic[d]}
        got = part.gather(dec.solve(part.scatter(b, field)), field)
        out[name] = float((got - want).abs().max() / want.abs().max())
    return out


def _run_case(name, tmpdir):
    """The case decomposed on [2, 2]: its fields gathered and its stats
    per step, as numpy."""
    from petibm_tpu_torch.convert import state_to_numpy
    from petibm_tpu_torch.parallel import counters, reset_counters

    build, cls, steps, _ = CASES[name]
    solver = _solver_class(cls, "petibm_tpu_torch")(
        build(tmpdir, sharding=dict(SHARDING, shape=[2, 2])), device="cpu")
    assert solver.part is not None and solver.part.pmesh.shape == (2, 2)
    state, stats = solver.state, []
    reset_counters()
    for _ in range(steps):
        state, s = solver._step_fn(state)
        stats.append({k: float(v) for k, v in s.items() if k != "f"})
    comm = counters()
    full = state_to_numpy(state, solver.part)
    solver.close()
    out = {f"q_{k}": v for k, v in full["q"].items()}
    out["p"] = full["p"]
    if "f" in full:
        out["f"] = full["f"]
    for key in stats[0]:
        out[f"stat_{key}"] = np.array([s[key] for s in stats])
    out["comm"] = np.array([comm[k]["calls"] for k in sorted(comm)])
    return out


def _job_four(rank, out):
    from petibm_tpu_torch.mesh import StaggeredMesh
    from petibm_tpu_torch.parallel import Partition, mesh_from_config

    res = {"mesh": {}}
    m = mesh_from_config(SHARDING)
    res["mesh"]["default"] = [list(m.shape), list(m.axis_names)]
    res["mesh"]["none"] = [mesh_from_config(None) is None,
                           mesh_from_config({"nDevices": 1}) is None]
    res["mesh"]["shape_4_1"] = list(
        mesh_from_config(dict(SHARDING, shape=[4, 1])).shape)
    for key, node in (("bad_shape", dict(SHARDING, shape=[3, 2])),
                      ("too_many", {"nDevices": 1000}),
                      ("three_axis", dict(SHARDING, shape=[1, 2, 2]))):
        try:
            got = mesh_from_config(node)
            res["mesh"][key] = [list(got.shape), list(got.axis_names)]
        except (ValueError, NotImplementedError) as err:
            res["mesh"][key] = [type(err).__name__, str(err)]
    res["layout"], res["fdm"] = {}, {}
    for shape in MESH_SHAPES:
        pm = mesh_from_config(dict(SHARDING, shape=shape))
        tag = f"{shape[0]}x{shape[1]}"
        for gname, cfg in LAYOUT_GRIDS.items():
            mesh = StaggeredMesh(cfg)
            res["layout"][f"{tag}-{gname}"] = _layout_checks(
                Partition(mesh, pm), mesh, seed=7)
        for gname, cfg in FDM_GRIDS.items():
            mesh = StaggeredMesh(cfg)
            for solve, err in _fdm_checks(Partition(mesh, pm), mesh, cfg,
                                          seed=11).items():
                res["fdm"][f"{tag}-{gname}-{solve}"] = err
    if rank == 0:
        publish_json(out, "four.json", res)
    for name in CASES:
        arr = _run_case(name, os.path.join(out, f"{name}-{rank}"))
        if rank == 0:
            publish_npz(out, f"{name}.npz", arr)


def init_ranks(rank: int, world: int, port: int) -> None:
    """Join the job's gloo group: one torch thread, and a collective that
    waits ``COLLECTIVE_TIMEOUT`` ends the rank with an error."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=COLLECTIVE_TIMEOUT)


def publish_json(out, name: str, obj) -> None:
    """Write ``obj`` as ``<out>/<name>`` under a temporary name first, so
    a reader never sees it half written."""
    tmp = os.path.join(str(out), f".{name}.tmp")
    with open(tmp, "w") as fh:
        json.dump(obj, fh)
    os.replace(tmp, os.path.join(str(out), name))


def publish_npz(out, name: str, arrays: dict) -> None:
    """``np.savez`` of ``arrays`` as ``<out>/<name>``, as ``publish_json``."""
    tmp = os.path.join(str(out), f".{name}.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(str(out), name))


def _rank_main(argv) -> None:
    import torch.distributed as dist

    job, rank, world, port, out = argv
    init_ranks(int(rank), int(world), int(port))
    {"four": _job_four}[job](int(rank), out)
    dist.destroy_process_group()


# --- the tests' side ---------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def _start_job(script: list, world: int, out) -> list:
    """Start ``python <script...> <rank> <world> <port> <out>`` as
    ``world`` rank processes (each one's output in ``<out>/rank<r>.log``)
    and return them without waiting."""
    port = _free_port()
    procs = []
    for r in range(world):
        with open(os.path.join(str(out), f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, *script, str(r), str(world), str(port),
                 str(out)], stdout=log, stderr=subprocess.STDOUT,
                env=_env()))
    return procs


def _log_tail(out, rank: int) -> str:
    with open(os.path.join(str(out), f"rank{rank}.log")) as fh:
        return fh.read()[-3000:]


class RankJob:
    """A job's rank processes, started now (``_start_job``).  ``path(name)``
    waits for the file ``name`` that rank 0 publishes in ``out``; it fails
    with the log of the rank that died where a rank exits with an error,
    with rank 0's log where the ranks end without the file, and with every
    rank's log where the job outlives ``timeout`` seconds from its start
    (the ranks are then stopped).  A file published before a failure
    stays readable."""

    def __init__(self, script: list, world: int, out, timeout: float):
        self.out = out
        self.timeout = timeout
        self.deadline = time.monotonic() + timeout
        self.procs = _start_job(script, world, out)

    def check(self, name: str) -> None:
        """Fail now where the file ``name`` is not there and a rank has
        failed or the job has outlived its time limit: a test calls it
        before its own long work, so a dead job costs the tests that read
        it no more time."""
        if (self.out / name).exists():
            return
        codes = [p.poll() for p in self.procs]
        failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
        if failed:
            self.stop()
            raise AssertionError("\n".join(
                f"rank {r} exited {codes[r]}:\n{_log_tail(self.out, r)}"
                for r in failed))
        if time.monotonic() > self.deadline:
            self.stop()
            raise AssertionError(
                f"no {name} within {self.timeout} s of the job's start "
                "(a hang):\n" + "\n".join(
                    f"rank {r}:\n{_log_tail(self.out, r)}"
                    for r in range(len(self.procs))))

    def path(self, name: str):
        path = self.out / name
        while not path.exists():
            self.check(name)
            if (all(p.poll() == 0 for p in self.procs)
                    and not path.exists()):
                raise AssertionError(f"the ranks ended without {name}:\n"
                                     f"{_log_tail(self.out, 0)}")
            time.sleep(0.2)
        return path

    def json(self, name: str) -> dict:
        with open(self.path(name)) as fh:
            return json.load(fh)

    def npz(self, name: str) -> dict:
        return dict(np.load(self.path(name)))

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


class _Four:
    """Job ``four``'s results as the tests read them: ``four[key]`` from
    ``four.json``, ``four.case(name)`` from the case's ``.npz``."""

    def __init__(self, job: RankJob):
        self.job = job
        self._res = None

    def __getitem__(self, key):
        if self._res is None:
            self._res = self.job.json("four.json")
        return self._res[key]

    def case(self, name: str) -> dict:
        return self.job.npz(f"{name}.npz")


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    job = RankJob([os.path.abspath(__file__), "four"], 4,
                  tmp_path_factory.mktemp("four_ranks"), TIMEOUT)
    yield _Four(job)
    job.stop()


def test_mesh_from_config_single_process():
    """One process: no mesh for no node or one device; more devices than
    processes is a configuration error (JAX test_mesh_from_config)."""
    from petibm_tpu_torch.parallel import mesh_from_config, process_info

    assert process_info() == (0, 1)
    assert mesh_from_config(None) is None
    assert mesh_from_config({"nDevices": 1}) is None
    for node in ({"nDevices": 2}, dict(SHARDING, nDevices=8),
                 {"nDevices": 1000}):
        with pytest.raises(ValueError, match="nDevices"):
            mesh_from_config(node)


def test_mesh_from_config_four_ranks(four):
    """The twin of tests/test_parallel.py::test_mesh_from_config on a
    4-process group."""
    m = four["mesh"]
    assert m["default"] == [[2, 2], ["dy", "dx"]]
    assert m["none"] == [True, True]
    assert m["shape_4_1"] == [4, 1]
    assert m["bad_shape"][0] == "ValueError"
    assert m["too_many"][0] == "ValueError"
    # a 3-axis shape is the ("dz", "dy", "dx") mesh
    assert m["three_axis"] == [[1, 2, 2], ["dz", "dy", "dx"]]


@pytest.mark.parametrize("shape", [f"{a}x{b}" for a, b in MESH_SHAPES])
def test_scatter_gather_and_halo(four, shape):
    """Every field's scatter -> gather round trip, face segments and halo
    slabs (neighbours, periodic wraps, none past walls) equal the full
    array's, bit for bit."""
    for gname in LAYOUT_GRIDS:
        worst = four["layout"][f"{shape}-{gname}"]
        assert worst == {"gather": 0.0, "halo": 0.0, "face": 0.0}, gname


@pytest.mark.parametrize("shape", [f"{a}x{b}" for a, b in MESH_SHAPES])
def test_sharded_fdm_matches_single(four, shape):
    """The four-all-to-all FDM solves equal the single-rank solves at 1e-12
    in float64: 2D stretched and odd; FFTs on z (3D), on x and y (2D), on
    y alone (its rfft), on x, y and z (3D)."""
    errs = {k: v for k, v in four["fdm"].items() if k.startswith(shape)}
    assert len(errs) == 3 + 4 + 3 + 3 + 4
    for name, err in errs.items():
        assert err <= 1e-12, (name, err)


def _run_jax(name, tmpdir):
    """The JAX package's single-device run of a case: fields and stats per
    step."""
    import jax

    build, cls, steps, _ = CASES[name]
    solver = _solver_class(cls, "petibm_tpu")(build(tmpdir))
    state, stats = solver.state, []
    for _ in range(steps):
        state, s = solver._step_fn(state)
        s = jax.device_get(s)
        stats.append({k: float(v) for k, v in s.items() if k != "f"})
    state = jax.device_get(state)
    solver.close()
    return state, stats


@pytest.mark.parametrize("name", sorted(CASES))
def test_decomposed_run_matches_jax_single(four, tmp_path, name):
    """A 4-rank [2, 2] run of the port equals the JAX package's
    single-device run: fields (and forces) within JAX's own
    sharded-versus-single bounds, iteration counts and ok flags equal on
    every step, and the step really exchanged halos, reduced and
    repartitioned."""
    _, _, steps, atol = CASES[name]
    four.job.check(f"{name}.npz")
    state, stats = _run_jax(name, tmp_path / "jax")
    got = four.case(name)
    for key, want in state["q"].items():
        np.testing.assert_allclose(got[f"q_{key}"], np.asarray(want),
                                   rtol=0, atol=atol, err_msg=key)
    np.testing.assert_allclose(got["p"], np.asarray(state["p"]), rtol=0,
                               atol=atol)
    if "f" in state:
        np.testing.assert_allclose(got["f"], np.asarray(state["f"]), rtol=0,
                                   atol=atol)
    for key in stats[0]:
        if key.endswith(("_iters", "_ok")):
            np.testing.assert_array_equal(
                got[f"stat_{key}"], [s[key] for s in stats], err_msg=key)
    # alltoall, allreduce, gather, halo: the step's collectives ran
    calls = dict(zip(("allreduce", "alltoall", "gather", "halo"),
                     got["comm"]))
    assert calls["halo"] > 0 and calls["allreduce"] > 0
    assert calls["alltoall"] > 0 and calls["alltoall"] % 4 == 0


def _write_case(directory, cfg):
    import yaml

    os.makedirs(directory, exist_ok=True)
    node = {k: cfg[k] for k in ("mesh", "flow", "parameters")}
    with open(os.path.join(directory, "config.yaml"), "w") as fh:
        yaml.safe_dump(node, fh)


def _torchrun(case, nproc: int = 2):
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         str(nproc), "--master-port", str(_free_port()), "-m",
         "petibm_tpu_torch.cli.navierstokes", "-directory", str(case),
         "-device", "cpu"], capture_output=True, text=True, env=_env(),
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]


def _same_h5(a_path, b_path, atol: float) -> None:
    import h5py

    with h5py.File(a_path) as a, h5py.File(b_path) as b:
        assert sorted(a) == sorted(b)
        for key in a:
            if isinstance(a[key], h5py.Dataset):
                np.testing.assert_allclose(b[key][()], a[key][()], rtol=0,
                                           atol=atol, err_msg=key)


def test_two_process_cli_matches_single(tmp_path):
    """The twin of tests/test_multihost.py: the navierstokes CLI under
    torch.distributed.run on 2 processes (gloo, [1, 2]) writes the
    iterations log and rank 0's snapshots and restart files of a
    single-process run; a decomposed restart from step 3 (each rank
    scattering the file's fields, histories and BC faces) ends where the
    single run did."""
    pytest.importorskip("h5py")
    from petibm_tpu_torch.cli.navierstokes import main

    cfg = cavity_config(tmp_path / "src")
    cfg["parameters"].update(nt=6, nsave=3, nrestart=3)
    single, multi = tmp_path / "single", tmp_path / "multi"
    _write_case(str(single), cfg)
    cfg["parameters"]["sharding"] = dict(SHARDING, shape=[1, 2])
    _write_case(str(multi), cfg)
    _torchrun(multi)
    assert main(["-directory", str(single), "-device", "cpu"]) == 0
    want = np.loadtxt(single / "output" / "iterations-0.txt")
    got = np.loadtxt(multi / "output" / "iterations-0.txt")
    assert got.shape == want.shape == (6, 5)
    np.testing.assert_array_equal(got[:, (0, 1, 3)], want[:, (0, 1, 3)])
    # residuals: printed to 6 digits, at the rounding floor (below the
    # solves' atol of 1e-12), where the sums' order shows
    np.testing.assert_allclose(got[:, 2::2], want[:, 2::2], rtol=1e-3,
                               atol=1e-12)
    for name in ("0000003.h5", "0000006.h5"):
        _same_h5(single / "output" / name, multi / "output" / name, 1e-10)
    # the restart: steps 4-6 again from step 3's file, decomposed
    os.rename(multi / "output" / "0000006.h5", tmp_path / "first.h5")
    cfg["parameters"].update(startStep=3, nt=3)
    _write_case(str(multi), cfg)
    _torchrun(multi)
    got = np.loadtxt(multi / "output" / "iterations-3.txt")
    np.testing.assert_array_equal(got[:, (0, 1, 3)], want[3:, (0, 1, 3)])
    _same_h5(tmp_path / "first.h5", multi / "output" / "0000006.h5", 1e-12)


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
