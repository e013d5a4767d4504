"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order (any failure raises and the script exits non-zero):

0. require CUDA; print the torch/CUDA versions and the card's name and
   power limit;
1. build the hand-written kernels K1-K7 from ``petibm_tpu_torch/csrc``,
   one nvcc per source, all at once, and print the registers and spills
   of the line kernels (K4/K5, K6/K7) and of K1, K2 and K3, instance by
   instance (``ptxas -v``); an instance of a z march (K1's 3D path, K2,
   K3) that spills fails the phase;
2. hold each kernel against its plain PyTorch twin on the card at the
   shapes of the main paths, and time both beside the kernel's bound
   (bytes moved once over 3.35 TB/s, or operations over the card's peak)
   (K1 and K2b both at the sphere's pressure shape, timed in turns);
   time one PyTorch call computing K1's (at both of its shapes), K2a's
   and K2b's function (``torch.sparse.mm`` on the operator assembled
   once as CSR; the port never calls it);
3. run the 2D decoupled-IBPM cylinder (Re=200, 450^2 stretched grid,
   157 body points, float32; the ``bench.py`` configuration) through
   ``DecoupledIBPMSolver.run()`` and check that K1 was launched as often
   as the solver stats say;
4. A/B the 2D steps with the kernels on and off (``disablePallas``);
5. run the 3D sphere (Re=300, 160x130x130 stretched grid, the 1963-point
   body of ``examples/decoupledibpm/sphere3dRe300``, float32) through
   ``run()``: 50 warm-up and 100 timed steps; K1, K2a and K3 launch
   counts against the stats (K3: one launch a step forms the three
   components); Cd and Cl;
6. run the 3D Taylor-Green vortex (Re=1600, 256^3 periodic, BiCGStab +
   Jacobi velocity solve, float32) through ``run()`` for 20 steps; K2a,
   K2b and K3 launch counts against the stats; the kinetic energy does
   not grow;
7. A/B short 3D runs with the kernels on and off, and a small 3D case on
   the card against the plain-PyTorch CPU path;
8. run the three cells again with ``fdm: false``, the multigrid-
   preconditioned CG pressure solve (the smoother's sweeps K4/K5 on
   non-periodic levels, K6/K7 on periodic ones): the flagship (20 warm-up
   and 100 timed steps), the sphere (20 steps) and the 256^3 TGV (10
   steps, the energy does not grow), each through ``run()`` with every
   launch count checked against the stats and its device busy share
   profiled over a few more steps (device ms per V-cycle beside the
   profile window's p_iters);
9. A/B the three MG-CG paths with the kernels on and off from their
   developed states, and small MG-CG cases on the card against the CPU
   path;
10. run the coupled IBPM through ``IBPMSolver.run()``:
   ``examples/ibpm/cylinder2dRe550`` and its pinned-pressure twin
   ``cylinder2dRe550_GPU`` (450^2 stretched, 314 points, float32) for
   1200 steps to t = 3 each, every solve converged, Cd(t) within rms 0.06
   and max 0.12 of the Koumoutsakos & Leonard (1995) curve over t in
   [0.5, 3], setup seconds (the Schur build) and ms/step printed, one
   JSON line each; Re=550 with ``fdm: false`` (CG on the coupled system,
   the V-cycle with K1 at its level-0 residual and the K4/K5 sweeps) for 5
   steps with its launches against the stats, one more step profiled,
   then one step A/B'd with the kernels off; small 2D and 3D coupled
   cases (K2a, K3) on the card against the CPU path;
11. run the moving body through ``RigidKinematicsSolver.run()``:
   ``examples/decoupledibpm/oscillatingcylinder2dRe100`` (512^2, the
   in-line oscillating cylinder, float32) for 600 steps, every solve
   converged, K1's launches against the stats (2 + p_iters a step), the
   in-line force, the force solve's fallbacks to the dense solve,
   ms/step and the device busy share printed, and the window recompute
   timed beside the same case with its body held still; a small float64
   moving body on the card against the CPU path.  Phase 0 says whether
   h5py imports: where it does not, the port writes its text logs only,
   and the restart round trip is held by the CPU tests alone;
12. the windowed delta engine, the matrix-free Krylov force solve,
   probes, vorticity and the stage profiler: (a) the sphere of phase 5
   with ``deltaEngine: windowed`` (the CG force solve, no
   preconditioner), its windowed E and H held to the factor engine's in
   float64 (1e-12), 5 steps converged with K1, K2a and K3 against the
   stats, f_iters, ms/step and the busy share; (b) the sphere refined to
   h = 1.2/90 in its inner box (220x190x190, the 17 671-point body of
   ``scripts/make_sphere_body.py``; ``auto`` picks the windowed engine):
   setup and window-build seconds, 5 steps (3 warm-up), ms/step, busy
   share, f_iters, peak memory, E and H of both engines (and the windowed
   one at the JAX package's 128 MB chunk budget) timed, K1, K2a and K3
   bit-equal to their twins at that shape; one ``{"windowed": ...}`` JSON
   line; (c) the flagship for 50 steps with a point probe on v and a
   time-averaged volume probe on p (ASCII), each file's last record held
   to the fields on the host (1e-6), and the vorticity on the card
   against the CPU (float64, 1e-12); (d) the stage profiler on the
   flagship and on (a): the phases chained bit-equal to the step, the
   JAX package's phase names, both tables printed.

Phase 2 holds K1 (450^2, the oscillating cylinder's 512^2 and the
sphere's pressure), K2a and K2b (every
shape), K3 (the sphere's and the TGV's three components from one
launch), K4/K5 (levels 0 and 1 of the flagship and of the sphere, every
line direction) and K6/K7 (the TGV's 256^3, 128^3 and 64^3 levels, every
axis) against their twins bit for bit, times K1's 3D march and K2 beside
their first designs (one thread per cell) at each 3D shape, and K4/K5
and K6/K7 at their finest levels beside their block paths.  The line
before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SPHERE_BODY = os.path.join(REPO, "examples", "decoupledibpm",
                           "sphere3dRe300", "sphere.body")
RE550_DIR = os.path.join(REPO, "examples", "ibpm", "cylinder2dRe550")
OSC_DIR = os.path.join(REPO, "examples", "decoupledibpm",
                       "oscillatingcylinder2dRe100")
KL_RE550 = os.path.join(REPO, "examples", "data", "koumoutsakos_leonard_"
                        "1995_cylinder_dragCoefficientRe550.dat")
#: the Re=550 bracket of scripts/validate_forces.py:_case_kl_cylinder: the
#: rms and the largest deviation of Cd(t) from the K&L curve, t in [0.5, 3]
KL_RMS, KL_MAX = 0.06, 0.12
KERNEL_SOURCES = ("poisson_separable", "zblocked_helmholtz", "convection3d",
                  "line_sweep", "tridiag_pcr")
#: the sources of a z march and the name of its kernel (csrc/march.cuh's
#: zmarch; K3's own), none of whose instances may spill
MARCH_SOURCES = {"poisson_separable": "zmarch", "zblocked_helmholtz": "zmarch",
                 "convection3d": "convection3d_march"}
DEVICE = "cuda"


def _circle(path: str, n: int) -> str:
    """A body file: n points on the circle of diameter 1 at the origin."""
    with open(path, "w") as fh:
        fh.write(f"{n}\n")
        for k in range(n):
            th = 2 * math.pi * k / n
            fh.write(f"{0.5 * math.cos(th):10.8e}\t"
                     f"{0.5 * math.sin(th):10.8e}\n")
    return path


def _solver_opts(max_it: int = 1000, **extra) -> dict:
    return dict({"type": "CPU", "atol": 1e-6, "rtol": 1e-6,
                 "max_it": max_it}, **extra)


def _base(tmp: str, mesh: list, flow: dict, **params) -> dict:
    """A configuration dict (the card need not have pyyaml); output goes
    to ``tmp``."""
    os.makedirs(tmp)
    parameters = {
        "nt": 10, "nsave": 10 ** 6, "nrestart": 10 ** 6,
        "dtype": "float32", "divergence": "abort",
        "convection": "ADAMS_BASHFORTH_2", "diffusion": "CRANK_NICOLSON",
        "velocitySolver": _solver_opts(), "poissonSolver": _solver_opts(),
        "forcesSolver": _solver_opts()}
    parameters.update(params)
    return {"directory": tmp, "output": os.path.join(tmp, "output"),
            "logs": os.path.join(tmp, "logs"), "mesh": mesh, "flow": flow,
            "parameters": parameters}


def _config(tmp: str, axes: tuple, nu: float, dt: float, npts: int,
            **params) -> dict:
    """A decoupled-IBPM cylinder in a uniform stream."""
    faces = {"xMinus": ("DIRICHLET", 1.0, 0.0), "xPlus": ("CONVECTIVE", 1.0, 1.0),
             "yMinus": ("DIRICHLET", 1.0, 0.0), "yPlus": ("DIRICHLET", 1.0, 0.0)}
    cfg = _base(tmp, [{"direction": d, "start": axes[0],
                       "subDomains": axes[1]} for d in ("x", "y")],
                {"nu": nu, "initialVelocity": [1.0, 0.0],
                 "boundaryConditions": [
                     {"location": loc, "u": [t, u], "v": [t, v]}
                     for loc, (t, u, v) in faces.items()]},
                **dict({"dt": dt}, **params))
    cfg["bodies"] = [{"type": "points",
                      "file": _circle(os.path.join(tmp, "circle.body"), npts)}]
    return cfg


def flagship_config(tmp: str, **params) -> dict:
    """The flagship of bench.py:43-83: Re=200 (nu 0.005, D = U = 1) on the
    450^2 grid stretched from a uniform 0.01 patch around the body, dt
    0.0025, 157 body points, float32."""
    sub = [{"end": -0.6, "cells": 120, "stretchRatio": 0.975},
           {"end": 0.6, "cells": 120, "stretchRatio": 1.0},
           {"end": 15.0, "cells": 210, "stretchRatio": 1.02}]
    return _config(tmp, (-15.0, sub), nu=0.005, dt=0.0025,
                   npts=int(round(2 * math.pi * 0.5 / 0.02)), **params)


def small_config(tmp: str, **params) -> dict:
    """A 32^2 cylinder (the flagship cut to size: uniform [-2, 2]^2,
    24 body points, Re=40)."""
    sub = [{"end": 2.0, "cells": 32, "stretchRatio": 1.0}]
    return _config(tmp, (-2.0, sub), nu=0.025, dt=0.005, npts=24, **params)


def re550_config(tmp: str, pinned: bool = False, **params) -> dict:
    """examples/ibpm/cylinder2dRe550 (``pinned``: cylinder2dRe550_GPU) as
    a dict: Re=550 (nu 1/550, D = U = 1) on 450^2 cells stretched from a
    uniform patch |x|, |y| <= 0.54, dt 0.0025, 1200 steps to t = 3, the
    example's 314-point body; BiCGStab + Jacobi velocity solve, CG + gamg
    pressure solve (the examples' .info files), atol 1e-6; ``pinned``
    sets the pressure solve's type to GPU (the pinned pressure)."""
    sub = [{"end": -0.54, "cells": 171, "stretchRatio": 0.980392156},
           {"end": 0.54, "cells": 108, "stretchRatio": 1.0},
           {"end": 15.0, "cells": 171, "stretchRatio": 1.02}]
    cfg = _config(tmp, (-15.0, sub), nu=0.00181818181818, dt=0.0025,
                  npts=314, **dict({
                      "nt": 1200,
                      "velocitySolver": _solver_opts(
                          10000, rtol=0.0, kspType="bicgstab", pc="jacobi"),
                      "poissonSolver": _solver_opts(
                          20000, rtol=0.0, pc="mg",
                          type="GPU" if pinned else "CPU")}, **params))
    cfg["bodies"] = [{"type": "points",
                      "file": os.path.join(RE550_DIR, "circle.body")}]
    return cfg


def oscillating_config(tmp: str, **params) -> dict:
    """examples/decoupledibpm/oscillatingcylinder2dRe100 as a dict: the
    in-line oscillating cylinder (Dutsch et al. 1998), Re = Um D / nu =
    100 (D = 1, KC = 5, f = 0.2: Am = D KC / 2 pi, Um = 2 pi f Am = 1;
    nu 0.01) in fluid at rest, 512^2 uniform cells
    on [-4, 4]^2 with no-slip walls, dt 0.002, the PESKIN_2002 delta, the
    example's body; the solvers' defaults (atol 1e-6); float32."""
    sub = [{"end": 4.0, "cells": 512, "stretchRatio": 1.0}]
    cfg = _base(tmp, [{"direction": d, "start": -4.0, "subDomains": sub}
                      for d in ("x", "y")],
                {"nu": 0.01, "initialVelocity": [0.0, 0.0],
                 "boundaryConditions": [
                     {"location": loc, "u": ["DIRICHLET", 0.0],
                      "v": ["DIRICHLET", 0.0]}
                     for loc in ("xMinus", "xPlus", "yMinus", "yPlus")]},
                **dict({"dt": 0.002, "startStep": 0, "nt": 10000,
                        "nsave": 100, "nrestart": 5000,
                        "delta": "PESKIN_2002",
                        "velocitySolver": {"type": "CPU"},
                        "poissonSolver": {"type": "CPU"},
                        "forcesSolver": {"type": "CPU"}}, **params))
    cfg["bodies"] = [{"type": "points", "name": "circle",
                      "file": os.path.join(OSC_DIR, "circle.body"),
                      "kinematics": {"type": "oscillation", "KC": 5.0,
                                     "D": 1.0, "f": 0.2,
                                     "center": [0.0, 0.0]}}]
    return cfg


def _sphere(path: str, n: int) -> str:
    """A body file: n points on the unit-diameter sphere at the origin
    (Fibonacci lattice)."""
    with open(path, "w") as fh:
        fh.write(f"{n}\n")
        for k in range(n):
            polar = math.acos(1.0 - 2.0 * (k + 0.5) / n)
            azim = math.pi * (1.0 + 5.0 ** 0.5) * (k + 0.5)
            fh.write(f"{0.5 * math.cos(azim) * math.sin(polar):.10e}\t"
                     f"{0.5 * math.sin(azim) * math.sin(polar):.10e}\t"
                     f"{0.5 * math.cos(polar):.10e}\n")
    return path


def small3d_config(tmp: str, **params) -> dict:
    """The sphere cut to 24x20x16 stretched cells in a walled box and a
    100-point body, Re=100, dt 0.01 (tests/test_torch_sphere3d.py)."""
    def axis(d, n_lo, n, end):
        return {"direction": d, "start": -2.0, "subDomains": [
            {"end": -0.6, "cells": n_lo, "stretchRatio": 0.9},
            {"end": 0.6, "cells": 8, "stretchRatio": 1.0},
            {"end": end, "cells": n - n_lo - 8, "stretchRatio": 1.1}]}

    faces = [("xMinus", "DIRICHLET", 0.0), ("xPlus", "CONVECTIVE", 1.0),
             ("yMinus", "DIRICHLET", 0.0), ("yPlus", "DIRICHLET", 0.0),
             ("zMinus", "DIRICHLET", 0.0), ("zPlus", "DIRICHLET", 0.0)]
    cfg = _base(tmp, [axis("x", 7, 24, 3.0), axis("y", 6, 20, 2.0),
                      axis("z", 4, 16, 2.0)],
                {"nu": 0.01, "initialVelocity": [1.0, 0.0, 0.0],
                 "boundaryConditions": [
                     {"location": loc, "u": [t, 1.0], "v": [t, vw],
                      "w": [t, vw]} for loc, t, vw in faces]},
                **dict({"dt": 0.01, "velocitySolver": _solver_opts(rtol=0.0),
                        "poissonSolver": _solver_opts(rtol=0.0)}, **params))
    cfg["bodies"] = [{"type": "points",
                      "file": _sphere(os.path.join(tmp, "sphere.body"), 100)}]
    return cfg


def sphere_config(tmp: str, **params) -> dict:
    """examples/decoupledibpm/sphere3dRe300 as a dict: Re=300 (nu 1/300,
    D = U = 1) on 160x130x130 cells stretched from a uniform 0.04 patch,
    dt 0.005, the example's 1963-point body, the example's solver
    settings (FDM velocity and pressure solves, dense force solve)."""
    def axis(d, end, n_hi, ratio_hi):
        return {"direction": d, "start": -15.0, "subDomains": [
            {"end": -0.6, "cells": 50, "stretchRatio": 0.92},
            {"end": 0.6, "cells": 30, "stretchRatio": 1.0},
            {"end": end, "cells": n_hi, "stretchRatio": ratio_hi}]}

    faces = [("xMinus", "DIRICHLET", 0.0), ("xPlus", "CONVECTIVE", 1.0),
             ("yMinus", "DIRICHLET", 0.0), ("yPlus", "DIRICHLET", 0.0),
             ("zMinus", "DIRICHLET", 0.0), ("zPlus", "DIRICHLET", 0.0)]
    cfg = _base(tmp, [axis("x", 25.0, 80, 1.06), axis("y", 15.0, 50, 1.087),
                      axis("z", 15.0, 50, 1.087)],
                {"nu": 0.00333333333333, "initialVelocity": [1.0, 0.0, 0.0],
                 "boundaryConditions": [
                     {"location": loc, "u": [t, 1.0], "v": [t, vw],
                      "w": [t, vw]} for loc, t, vw in faces]},
                **dict({"dt": 0.005, "velocitySolver": _solver_opts(
                    10000, rtol=0.0, kspType="bicgstab"),
                    "poissonSolver": _solver_opts(20000, rtol=0.0, pc="mg"),
                    "forcesSolver": _solver_opts(10000, rtol=0.0)}, **params))
    cfg["bodies"] = [{"type": "points", "file": SPHERE_BODY}]
    return cfg


def tgv3d_config(tmp: str, n: int = 256, **params) -> dict:
    """examples/navierstokes/taylorgreenvortex3dRe1600 as a dict: Re=1600
    (nu 0.000625) on an n^3 periodic box [-pi, pi]^3, dt 0.01, BiCGStab +
    Jacobi velocity solve (fdm.velocity: false), FDM pressure solve.  The
    initial fields are set by ``tgv3d_initial_state`` (numpy)."""
    pi = math.pi
    return _base(tmp, [{"direction": d, "start": -pi, "subDomains": [
        {"end": pi, "cells": n, "stretchRatio": 1.0}]} for d in "xyz"],
        {"nu": 0.000625, "initialVelocity": [0.0, 0.0, 0.0],
         "boundaryConditions": [
             {"location": d + side, **{f: ["PERIODIC", 0.0] for f in "uvw"}}
             for d in "xyz" for side in ("Minus", "Plus")]},
        **dict({"dt": 0.01, "fdm": {"velocity": False},
                "velocitySolver": _solver_opts(10000, rtol=0.0,
                                               kspType="bicgstab"),
                "poissonSolver": _solver_opts(20000, rtol=0.0, pc="mg")},
               **params))


def tgv3d_initial_state(solver) -> None:
    """The example's symbolic initial conditions, evaluated with numpy at
    the staggered points and loaded through convert.state_from_numpy:
    u = sin x cos y cos z, v = -cos x sin y cos z, w = 0,
    p = (cos 2x + cos 2y)(cos 2z + 2)/16."""
    import numpy as np

    from petibm_tpu_torch.convert import state_from_numpy, state_to_numpy
    from petibm_tpu_torch.types import Field

    def grid(field):
        z, y, x = np.meshgrid(*(solver.mesh.coord(field, d)
                                for d in (2, 1, 0)), indexing="ij")
        return x, y, z

    x, y, z = grid(Field.U)
    u = np.sin(x) * np.cos(y) * np.cos(z)
    x, y, z = grid(Field.V)
    v = -np.cos(x) * np.sin(y) * np.cos(z)
    x, y, z = grid(Field.P)
    p = (np.cos(2 * x) + np.cos(2 * y)) * (np.cos(2 * z) + 2) / 16
    state = state_to_numpy(solver.state)
    state["q"] = {"u": u, "v": v, "w": np.zeros(solver.mesh.shape(Field.W))}
    state["p"] = p
    solver.state = state_from_numpy(state, solver.device, solver.dtype)


def _time_ms(fn, arg, applies: int = 200, batch: int = 20) -> tuple:
    """Median times of one ``fn(arg)`` over ``applies`` calls, in batches
    of ``batch`` after a warm-up: (device ms, host ms).

    Device: CUDA events around a batch that the host enqueued while the
    card was held busy by a spin kernel, so the batch runs back to back
    and launch overhead on the host is not in the number.  Host: wall
    clock per call of a synchronised batch, which is what a caller that
    enqueues one call at a time waits."""
    import torch

    for _ in range(10):
        fn(arg)
    torch.cuda.synchronize()
    device, host = [], []
    for _ in range(applies // batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # ~25 ms: outlasts the enqueueing
        start.record()
        for _ in range(batch):
            fn(arg)
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end) / batch)
        t0 = time.perf_counter()
        for _ in range(batch):
            fn(arg)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3 / batch)
    return statistics.median(device), statistics.median(host)


def phase0_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"matmul TF32: {torch.backends.cuda.matmul.allow_tf32}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on; the port computes in full f32")
    print(smi)
    from petibm_tpu_torch.io import hdf5_available

    print("h5py imports: " + ("yes (snapshots and restart files are "
                              "written)" if hdf5_available() else
                              "no (the solvers write their text logs "
                              "only; restarts are refused)"))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase1_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from petibm_tpu_torch import _kernels

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        built = list(pool.map(_kernels.build, KERNEL_SOURCES))
    for (path, seconds) in built:
        print(f"built {path.name} in {seconds:.2f} s"
              + (" (already built)" if seconds == 0.0 else ""))
    print(f"kernel builds: {time.perf_counter() - t0:.2f} s wall")
    # registers and spills, instance by instance (ptxas -v)
    spills = []
    for source in ("line_sweep", "tridiag_pcr", *MARCH_SOURCES):
        log = _kernels.BUILD_LOGS.get(source)
        if log is None:
            print(f"{source} was already built: no ptxas report")
            continue
        name = "?"
        for line in log.splitlines():
            if "Function properties for" in line:
                name = line.split("Function properties for")[-1].strip()
            elif "spill" in line or "Used" in line:
                print(f"ptxas {source} {name}: {line.strip()}")
                if (MARCH_SOURCES.get(source, "?") in name
                        and "spill" in line
                        and " 0 bytes spill stores, 0 bytes spill loads"
                        not in line):
                    spills.append(name)
    if spills:
        raise AssertionError(f"z march instances spill: {spills}")


def _mesh_and_bcs(cfg: dict):
    from petibm_tpu_torch.boundary import BoundarySet
    from petibm_tpu_torch.mesh import StaggeredMesh

    mesh = StaggeredMesh(cfg)
    return mesh, BoundarySet(mesh, cfg)


def _rel_err(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


#: H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, and operations/s
#: outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "float64": 34e12}


def _bound(nbytes: float, ops: float, dtype) -> tuple:
    """The least time the card could take (ms) for ``nbytes`` moved once
    and ``ops`` operations of ``dtype``, and which of the two binds."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[str(dtype)[6:]]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _hold(label: str, kernel, twin, arg, tol: float, applies: int,
          work: tuple):
    """One kernel against its twin on ``arg``: relative error within
    ``tol`` (0: bit for bit), then both timed; ``work`` = (bytes read once
    and written once, operations, dtype) gives the bound.  Returns the
    record of the JSON line."""
    import torch

    got, want = kernel(arg), twin(arg)
    torch.cuda.synchronize()
    # a kernel of several outputs (K3) is held output by output
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    errs = [float((g - w).abs().max()) for g, w in pairs]
    rels = [e / float(w.abs().max()) for e, (_, w) in zip(errs, pairs)]
    err, rel = max(errs), max(rels)
    each = ("" if len(pairs) == 1 else " (each output "
            + " / ".join(f"{e:.3e}" for e in errs) + ")")
    ms, host_ms = _time_ms(kernel, arg, applies)
    plain_ms, plain_host_ms = _time_ms(twin, arg, applies)
    bound_ms, bound_by = _bound(*work)
    print(f"{label}: max|kernel-twin| {err:.3e}{each} (rel {rel:.3e}, tol "
          f"{tol:g}); "
          f"per apply (median), device: kernel {ms * 1e3:.2f} us, twin "
          f"{plain_ms * 1e3:.2f} us; host wall: kernel {host_ms * 1e3:.2f} "
          f"us, twin {plain_host_ms * 1e3:.2f} us; bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by}: {work[0] / 1e6:.1f} MB, "
          f"{work[1] / 1e9:.3f} Gop), share {bound_ms / ms:.3f}")
    if not rel <= tol:
        raise AssertionError(f"{label}: rel error {rel} > {tol}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def _csr(diag, terms):
    """The sparse (CSR) matrix of f -> diag * f + sum of coef * f[i + step
    along axis] over ``terms`` (axis, step, coef, periodic): a wrapped
    neighbour on a periodic axis, none past a wall."""
    import torch

    shape, dev = diag.shape, diag.device
    idx = torch.arange(diag.numel(), device=dev).reshape(shape)
    rows, cols, vals = [idx.reshape(-1)], [idx.reshape(-1)], [diag.reshape(-1)]
    for axis, step, coef, periodic in terms:
        col = torch.roll(idx, -step, axis)
        pos = torch.arange(shape[axis], device=dev).reshape(
            [-1 if a == axis else 1 for a in range(len(shape))])
        keep = ((pos + step >= 0) & (pos + step < shape[axis])) | periodic
        keep = keep.expand(shape)
        rows.append(idx[keep])
        cols.append(col[keep])
        vals.append(coef.expand(shape)[keep])
    n = diag.numel()
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows),
                                               torch.cat(cols)]),
                                  torch.cat(vals), (n, n))
    return coo.coalesce().to_sparse_csr()


def _k1_csr(level):
    """K1's operator (poisson_apply_separable_ref) as a CSR matrix."""
    ndim, diag, terms = len(level.shape), 0.0, []
    for d in range(ndim):
        axis = ndim - 1 - d
        c = level.c1d[d]
        n = c.shape[0] - 1
        c_lo = c[:-1].reshape(level.bshape(d, n))
        c_hi = c[1:].reshape(level.bshape(d, n))
        area = 1.0
        for e in range(ndim):
            if e != d:
                area = area * level.w1d[e].reshape(
                    level.bshape(e, level.w1d[e].shape[0]))
        diag = diag + area * (c_lo + c_hi)
        terms += [(axis, -1, -area * c_lo, False),
                  (axis, 1, -area * c_hi, False)]
    return _csr(diag.expand(tuple(level.shape)), terms)


def _k2_csr(shape, vecs, periodic, scale=None):
    """K2's operator (zblocked_helmholtz_apply_ref) as a CSR matrix."""
    from petibm_tpu_torch.operators.cuda_stencil import _axis_vec

    s = 1.0
    if scale is not None:
        s = (_axis_vec(scale[0], 0) * _axis_vec(scale[1], 1)
             * _axis_vec(scale[2], 2))
    diag = sum(_axis_vec(vecs["D" + t], a) for a, t in enumerate("zyx"))
    terms = [(a, step, s * _axis_vec(vecs[key + t], a), periodic[a])
             for a, t in enumerate("zyx")
             for step, key in ((-1, "CN"), (1, "CP"))]
    return _csr((diag * s).expand(shape), terms)


def _library(label: str, rec: dict, csr, arg, want, applies: int) -> None:
    """One PyTorch call computing the kernel's function, timed on ``arg``
    beside the kernel (``rec``): ``torch.sparse.mm`` with the operator
    assembled once as CSR.  Its result is held to the kernel's ``want``
    at 1e-5 relative (another order of summation)."""
    import torch

    col = arg.reshape(-1, 1)
    rel = _rel_err(torch.sparse.mm(csr, col).reshape(arg.shape), want)
    rec["library_ms"] = _time_ms(lambda v: torch.sparse.mm(csr, v), col,
                                 applies)[0]
    print(f"{label} library torch.sparse.mm (CSR, {csr.values().numel()} "
          f"values): {rec['library_ms'] * 1e3:.2f} us per apply (device), "
          f"kernel {rec['ms'] * 1e3:.2f} us; rel diff {rel:.3e} (tol 1e-5)")
    if not rel <= 1e-5:
        raise AssertionError(f"{label}: the CSR operator differs: {rel}")


def _steps(n: int) -> int:
    """PCR passes of an n-row line: ceil(log2 n)."""
    return (n - 1).bit_length()


def phase2_kernels(tmp: str) -> dict:
    """Every kernel against its plain twin on the card at the main paths'
    shapes (float32 timed, float64 checked and timed briefly), each with
    its bound; K1, K2a and K2b also beside one PyTorch call (a CSR
    product); K6/K7 also beside its block path.  Returns the record of
    each kernel for the JSON line."""
    import torch

    from petibm_tpu_torch.linalg import cuda_pcr, cuda_sweep
    from petibm_tpu_torch.linalg.mg import PoissonMG, poisson_level0
    from petibm_tpu_torch.operators import cuda_stencil as cs

    cuda = torch.device(DEVICE)
    gen = torch.Generator(device=cuda).manual_seed(0)
    tols = {torch.float32: 1e-6, torch.float64: 1e-13}
    records = {}
    cases = {"450x450": flagship_config(os.path.join(tmp, "k_flagship")),
             "oscillating": oscillating_config(os.path.join(tmp, "k_osc")),
             "sphere": sphere_config(os.path.join(tmp, "k_sphere")),
             "tgv256": tgv3d_config(os.path.join(tmp, "k_tgv"))}
    meshes = {name: _mesh_and_bcs(cfg) for name, cfg in cases.items()}

    def randn(shape, dtype):
        return torch.randn(tuple(shape), generator=gen, device=cuda,
                           dtype=dtype)

    def numel(tensors):
        return sum(t.numel() for t in tensors)

    for dtype in (torch.float32, torch.float64):
        tag = str(dtype)[6:]
        size = torch.finfo(dtype).bits // 8
        applies = 200 if dtype == torch.float32 else 40
        tol = tols[dtype]
        # K1: the flagship's, the oscillating cylinder's and the sphere's
        # pressure, bit for bit
        for name in ("450x450", "oscillating", "sphere"):
            mesh = meshes[name][0]
            level = poisson_level0(mesh.dxp, mesh.periodic, dtype=dtype,
                                   device=cuda,
                                   scale=cases[name]["parameters"]["dt"])
            phi = randn(level.shape, dtype)
            rec = _hold_k1(f"K1 {name} p {tuple(level.shape)} {tag}", level,
                           phi, applies)
            if dtype == torch.float32:
                _library(f"K1 {name} p {tag}", rec, _k1_csr(level), phi,
                         cs.poisson_apply_separable(phi, level), applies)
                if name == "sphere":
                    records["K1"] = rec
            if name == "sphere":
                _k1_beside(f"K1 sphere p {tuple(level.shape)} {tag}", phi,
                           level, tol, applies)
        # K2a: the sphere's three velocity components, one TGV component
        for name, comps in (("sphere", "uvw"), ("tgv256", "u")):
            mesh, bcs = meshes[name]
            params = cases[name]["parameters"]
            A = cs.make_cuda_momentum(mesh, bcs, params["dt"],
                                      0.5 * cases[name]["flow"]["nu"],
                                      dtype=dtype, device=cuda)
            for comp in comps:
                vecs = A.vecs[comp]
                f = randn(mesh.shape("uvw".index(comp)), dtype)
                rec = _hold_k2(f"K2a {name} {comp} {tuple(f.shape)} {tag}", f,
                               vecs, A.periodic, None, tol, applies)
                if (name, comp, dtype) == ("sphere", "u", torch.float32):
                    records["K2a"] = rec
                    _library(f"K2a sphere u {tag}", rec,
                             _k2_csr(tuple(f.shape), vecs, A.periodic), f,
                             cs.zblocked_helmholtz_apply(f, vecs, A.periodic),
                             applies)
        # K2b: the TGV's periodic pressure
        mesh = meshes["tgv256"][0]
        level = poisson_level0(mesh.dxp, mesh.periodic, dtype=dtype,
                               device=cuda,
                               scale=cases["tgv256"]["parameters"]["dt"])
        k2b = cs.make_cuda_poisson_zblocked(level)
        phi = randn(level.shape, dtype)
        rec = _hold_k2(f"K2b tgv256 p {tuple(level.shape)} periodic {tag}",
                       phi, k2b.vecs, k2b.periodic, k2b.scale, tol, applies)
        if dtype == torch.float32:
            records["K2b"] = rec
            _library(f"K2b tgv256 p {tag}", rec,
                     _k2_csr(tuple(phi.shape), k2b.vecs, k2b.periodic,
                             k2b.scale), phi, k2b(phi), applies)
        # K3: the sphere's and the TGV's three components from one launch,
        # bit for bit; bound: the three extended arrays read once and the
        # three outputs written once
        for name in ("sphere", "tgv256"):
            mesh, bcs = meshes[name]
            q = {k: randn(mesh.shape(c), dtype) for c, k in enumerate("uvw")}
            rec = _hold_k3(f"K3 {name}", mesh, bcs, q, applies)
            if (name, dtype) == ("sphere", torch.float32):
                records["K3"] = rec
        # K4/K5: the fused sweep on levels 0 and 1 of the flagship and of
        # the sphere, every line direction, bit for bit; at level 0 also
        # the block path (the first design, which takes lines of any length),
        # in turns
        for name in ("450x450", "sphere"):
            mesh = meshes[name][0]
            mg = PoissonMG(mesh.dxp, mesh.periodic, dtype=dtype, device=cuda,
                           scale=cases[name]["parameters"]["dt"])
            for lvl in (0, 1):
                shape = tuple(mg.levels[lvl].shape)
                pair = (randn(shape, dtype), randn(shape, dtype))
                n = pair[0].numel()
                shape3 = (1,) * (3 - mesh.dim) + shape
                for d in range(mesh.dim):
                    axis, aux = mesh.dim - 1 - d, mg._aux(lvl, d)
                    axis3 = axis + 3 - mesh.dim
                    plan = cuda_sweep.launch_plan(shape3, axis3)
                    ops = 7 + 6 * (mesh.dim - 1) + 14 * _steps(shape[axis])
                    label = (f"K4/K5 {name} level {lvl} {shape} direction "
                             f"{d} {tag}")
                    rec = _hold(
                        f"{label} {plan}",
                        lambda a: cuda_sweep.fused_sweep(a[0], a[1], aux, axis,
                                                         1.0),
                        lambda a: cuda_sweep.fused_sweep_ref(a[0], a[1], aux,
                                                             axis, 1.0),
                        pair, 0.0, applies if lvl else applies // 2,
                        ((3 * n + numel(aux)) * size, ops * n, dtype))
                    if (name, lvl, d, dtype) == ("sphere", 0, 0,
                                                 torch.float32):
                        records["K4/K5"] = rec
                    if lvl == 0:
                        _block_ab(label, lambda p: lambda a: cuda_sweep.launch(
                            a[0], a[1], aux, axis, 1.0, p), plan,
                            cuda_pcr.block_plan(shape3, axis3), pair,
                            applies // 2)
            del mg
        # K6/K7: the TGV's line systems at 256^3, 128^3 and 64^3 (levels
        # 0-2), every axis, bit for bit; at 256^3 also the block path (the
        # first design, which takes lines of any length), in turns
        mesh = meshes["tgv256"][0]
        mg = PoissonMG(mesh.dxp, mesh.periodic, dtype=dtype, device=cuda,
                       scale=cases["tgv256"]["parameters"]["dt"])
        for lvl in (0, 1, 2):
            shape = tuple(mg.levels[lvl].shape)
            rhs = randn(shape, dtype)
            n = rhs.numel()
            for d in range(3):
                axis = 2 - d
                dl, diag, du = mg._line_system(lvl, d)
                plan = cuda_pcr.launch_plan(shape, axis)
                rec = _hold(
                    f"K6/K7 tgv256 level {lvl} {shape} axis {axis} {plan} "
                    f"{tag}",
                    lambda x: cuda_pcr.pcr(dl, diag, du, x, axis),
                    lambda x: cuda_pcr.pcr_ref(dl, diag, du, x, axis), rhs,
                    0.0, applies if lvl else applies // 2,
                    (5 * n * size, (14 * _steps(shape[axis]) + 1) * n, dtype))
                if (lvl, axis, dtype) == (0, 0, torch.float32):
                    records["K6/K7"] = rec
                if lvl == 0:
                    _block_ab(f"K6/K7 tgv256 level 0 axis {axis} {tag}",
                              lambda p: lambda x: cuda_pcr.launch(
                                  dl, diag, du, x, axis, p), plan,
                              cuda_pcr.block_plan(shape, axis), rhs,
                              applies // 2)
        del mg, dl, diag, du
    return records


def _hold_k1(label: str, level, phi, applies: int) -> dict:
    """K1 against its twin bit for bit on ``phi``, timed beside its bound
    (the field read and written once, and the 1D factors)."""
    from petibm_tpu_torch.operators import cuda_stencil as cs

    n = phi.numel()
    small = sum(t.numel() for t in level.c1d + level.w1d)
    plan = (f" plan {tuple(cs.separable_plan_on_card(phi))}"
            if phi.ndim == 3 else "")
    return _hold(f"{label}{plan}",
                 lambda x: cs.poisson_apply_separable(x, level),
                 lambda x: cs.poisson_apply_separable_ref(x, level),
                 phi, 0.0, applies,
                 ((2 * n + small) * phi.element_size(),
                  (26 if phi.ndim == 3 else 15) * n, phi.dtype))


def _hold_k3(label: str, mesh, bcs, q: dict, applies: int) -> dict:
    """K3 forming u, v and w from one launch on the ghost-extended ``q``,
    held output by output to its twin bit for bit; bound: the three
    extended arrays read once and the three outputs written once."""
    from petibm_tpu_torch.operators import cuda_stencil as cs

    u = q["u"]
    conv = cs.make_cuda_convection(mesh, bcs, dtype=u.dtype, device=u.device)
    state = bcs.init_state(q)
    ext = [bcs.extend(q[k], c, state) for c, k in enumerate("uvw")]
    n = sum(t.numel() for t in q.values())
    small = sum(v.numel() for iv in conv.inv_dl for v in iv)
    return _hold(
        f"{label} u/v/w " + " ".join(str(tuple(q[k].shape)) for k in "uvw")
        + f" {str(u.dtype)[6:]} plan {tuple(cs.convection_plan_on_card(ext))}",
        lambda e: cs.convection3d_apply(e, conv.inv_dl),
        lambda e: tuple(cs.convection3d_apply_ref(e, c, conv.inv_dl[c])
                        for c in range(3)), ext, 0.0, applies,
        ((sum(t.numel() for t in ext) + n + small) * u.element_size(),
         34 * n, u.dtype))


def _hold_k2(label: str, f, vecs, periodic, scale, cells_tol: float,
             applies: int) -> dict:
    """K2 (the wrapper, with ``plan_on_card``'s plan) against its twin bit
    for bit, timed beside its bound; then its first design (one thread
    per cell) held to the twin within ``cells_tol`` and timed against
    the plan in turns (plan, cells, cells, plan).  Returns the record of
    the JSON line."""
    import torch

    from petibm_tpu_torch.operators import cuda_stencil as cs

    size = torch.finfo(f.dtype).bits // 8
    n = f.numel()
    small = sum(v.numel() for v in vecs.values()) + (
        0 if scale is None else sum(s.numel() for s in scale))
    plan = cs.plan_on_card(f, scale is not None)
    rec = _hold(f"{label} plan {tuple(plan)}",
                lambda x: cs.zblocked_helmholtz_apply(x, vecs, periodic,
                                                      scale),
                lambda x: cs.zblocked_helmholtz_apply_ref(x, vecs, periodic,
                                                          scale),
                f, 0.0, applies,
                ((2 * n + small) * size, (15 if scale is None else 18) * n,
                 f.dtype))

    def march(x):
        return cs.launch(x, vecs, periodic, scale, plan)

    def cells(x):
        return cs.launch_cells(x, vecs, periodic, scale)

    rel = _rel_err(cells(f), cs.zblocked_helmholtz_apply_ref(
        f, vecs, periodic, scale))
    if not rel <= cells_tol:
        raise AssertionError(f"{label}: the cell kernel differs: {rel}")
    times = [_time_ms(g, f, applies)[0] * 1e3
             for g in (march, cells, cells, march)]
    print(f"{label}: plan {times[0]:.2f}, {times[3]:.2f} us; cell kernel "
          f"{times[1]:.2f}, {times[2]:.2f} us (device, median per apply; "
          f"cell kernel rel err {rel:.3e}, tol {cells_tol:g})")
    return rec


def _k1_beside(label: str, phi, level, tol: float, applies: int) -> None:
    """K1's 3D march beside its first design (one thread per cell), equal
    to the twin bit for bit, and beside K2b, the same operator at the same
    shape (equal within ``100 * tol``), each timed in turns (march, other,
    other, march)."""
    import torch

    from petibm_tpu_torch.operators import cuda_stencil as cs

    want = cs.poisson_apply_separable_ref(phi, level)
    if not torch.equal(cs.separable_launch_cells(phi, level), want):
        raise AssertionError(f"{label}: the cell kernel differs from the "
                             "twin")

    def march(x):
        return cs.poisson_apply_separable(x, level)

    def cells(x):
        return cs.separable_launch_cells(x, level)

    k2b = cs.make_cuda_poisson_zblocked(level)
    _hold_k2(f"K2b {label[3:]}", phi, k2b.vecs, k2b.periodic,
             k2b.scale, tol, applies)
    rel = _rel_err(k2b(phi), want)
    print(f"K2b vs K1, {label[3:]}: rel diff {rel:.3e}")
    if not rel <= 100 * tol:
        raise AssertionError(f"K2b and K1 differ: {rel}")
    for other, fn in (("cell kernel", cells), ("K2b", k2b)):
        times = [_time_ms(g, phi, applies)[0] * 1e3
                 for g in (march, fn, fn, march)]
        print(f"{label}: march {times[0]:.2f}, {times[3]:.2f} us; {other} "
              f"{times[1]:.2f}, {times[2]:.2f} us (device, median per "
              "apply)")


def _block_ab(label: str, launch, plan, block, arg, applies: int) -> None:
    """A line kernel's plan against its block path on the same input
    (``launch(plan)`` is the function of ``arg`` that launches ``plan``):
    equal bits, then timed in turns (plan, block, block, plan)."""
    import torch

    if not torch.equal(launch(plan)(arg), launch(block)(arg)):
        raise AssertionError(f"{label}: the plan and the block path differ")
    times = [_time_ms(launch(p), arg, applies)[0]
             for p in (plan, block, block, plan)]
    print(f"{label}: {plan.path} R{plan.rows} {times[0] * 1e3:.2f}, "
          f"{times[3] * 1e3:.2f} us; block path {times[1] * 1e3:.2f}, "
          f"{times[2] * 1e3:.2f} us (device, median per apply, equal bits)")


def _reset_counts() -> None:
    from petibm_tpu_torch.linalg import cuda_pcr, cuda_sweep
    from petibm_tpu_torch.operators import cuda_stencil as cs

    cs.poisson_apply_separable.launches = 0
    cs.zblocked_helmholtz_apply.launches = 0
    cs.zblocked_helmholtz_apply.scaled_launches = 0
    cs.convection3d_apply.launches = 0
    cuda_sweep.fused_sweep.launches = 0
    cuda_pcr.pcr.launches = 0


def _counts() -> dict:
    """Launches since the last reset: K1, K2a (unscaled K2), K2b (scaled
    K2), K3, K4/K5 and K6/K7."""
    import torch

    from petibm_tpu_torch.linalg import cuda_pcr, cuda_sweep
    from petibm_tpu_torch.operators import cuda_stencil as cs

    torch.cuda.synchronize()
    k2 = cs.zblocked_helmholtz_apply
    return {"K1": cs.poisson_apply_separable.launches,
            "K2a": k2.launches - k2.scaled_launches,
            "K2b": k2.scaled_launches,
            "K3": cs.convection3d_apply.launches,
            "K4/K5": cuda_sweep.fused_sweep.launches,
            "K6/K7": cuda_pcr.pcr.launches}


def _check_counts(label: str, got: dict, want: dict) -> None:
    """``want`` names the kernels the path launches; the others must not
    have launched."""
    want = {key: want.get(key, 0) for key in got}
    print(f"{label} launches {got}, implied by the stats {want}")
    if got != want:
        raise AssertionError(f"{label}: launches {got} != implied {want}")


def _check_run(hist: list, nsteps: int, keys: str) -> None:
    if len(hist) != nsteps:
        raise AssertionError(f"ran {len(hist)} steps, expected {nsteps}")
    bad = [s["ite"] for s in hist
           if not all(s[f"{k}_ok"] for k in keys)]
    if bad:
        raise AssertionError(f"solver not converged at steps {bad[:10]}")


def _check_fields(fields: dict, shapes: dict) -> None:
    import torch

    for name, arr in fields.items():
        if tuple(arr.shape) != tuple(shapes[name]):
            raise AssertionError(f"{name} shape {tuple(arr.shape)} != "
                                 f"{tuple(shapes[name])}")
        if not bool(torch.isfinite(arr).all()):
            raise AssertionError(f"{name} has non-finite values")


def phase3_slice(tmp: str):
    """The 450^2 flagship through run(); returns (solver, launches)."""
    import torch

    from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver

    t0 = time.perf_counter()
    solver = DecoupledIBPMSolver(flagship_config(os.path.join(tmp, "run"),
                                                 nt=100), device=DEVICE)
    torch.cuda.synchronize()
    print(f"setup {time.perf_counter() - t0:.2f} s: {solver.mesh.info()}"
          .replace("\n", "; "))
    print(f"bodies: {solver.bodies.n_pts} points; dtype {solver.dtype}")

    # the main path: steps 1-100, then 101-300 timed (the run extended)
    _reset_counts()
    solver.run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.nt = 300
    solver.run()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = _counts()
    solver.close()

    hist = solver.stats_history
    _check_run(hist, 300, "vpf")
    _check_counts("flagship", launches,
                  {"K1": sum(2 + s["p_iters"] for s in hist),
                   "K2a": 0, "K2b": 0, "K3": 0})
    st = solver.state
    nx, ny = (sum(sub["cells"] for sub in ax["subDomains"])
              for ax in solver.config["mesh"])
    _check_fields({"u": st["q"]["u"], "v": st["q"]["v"], "p": st["p"],
                   "f": st["f"]},
                  {"u": (ny, nx - 1), "v": (ny - 1, nx), "p": (ny, nx),
                   "f": (solver.bodies.n_pts, 2)})
    fx, fy = solver.bodies.avg_forces(st["f"].cpu().numpy())[0]
    last = hist[-1]
    print(f"{elapsed / 200 * 1e3:.3f} ms/step over steps 101-300 "
          f"(synchronised); last step v/p/f iters {last['v_iters']}/"
          f"{last['p_iters']}/{last['f_iters']}; t = {solver.t:.4f}: "
          f"Cd {2 * fx:.5f}, Cl {2 * fy:.5f}")
    return solver, launches


def _ab(label: str, make, start, nsteps: int, fields_of,
        f32_tol: float = 1e-5, f64_tol: float = 1e-5,
        same_iters: bool = False) -> None:
    """``nsteps`` steps from the state ``start`` with the kernels on and
    off (disablePallas), in float64 and float32.  In float64 every field
    must agree to ``f64_tol`` (p to no less than 1e-8), and with
    ``same_iters`` every iteration count must be equal; in float32 the
    pressure is only determined to the solve's tolerance (its low modes
    amplify the two operators' different roundings of the residual by the
    condition number), so float32 holds the other fields to ``f32_tol``
    and reports p."""
    from petibm_tpu_torch.convert import state_from_numpy

    for dtype in ("float64", "float32"):
        runs = {}
        for name, disable in (("kernels", False), ("stencil", True)):
            s = make(f"ab_{label}_{dtype}_{name}", nt=nsteps, dtype=dtype,
                     disablePallas=disable)
            s.state = state_from_numpy(start, DEVICE, s.dtype)
            s.run()
            s.close()
            runs[name] = s
            print(f"{label} {dtype} {name}: v/p(/f) iters " + " ".join(
                "/".join(str(h[k]) for k in ("v_iters", "p_iters", "f_iters")
                         if k in h) for h in s.stats_history))
        a, b = fields_of(runs["kernels"]), fields_of(runs["stencil"])
        if same_iters and dtype == "float64":
            iters = [[{k: v for k, v in h.items() if k.endswith("_iters")}
                      for h in runs[name].stats_history] for name in runs]
            if iters[0] != iters[1]:
                raise AssertionError(f"{label} kernel / stencil A/B "
                                     f"iteration counts differ: {iters}")
        for key in a:
            rel = _rel_err(a[key], b[key])
            held = dtype == "float64" or key != "p"
            tol = f32_tol
            if dtype == "float64":
                tol = f64_tol if key != "p" else max(f64_tol, 1e-8)
            print(f"A/B {label} {dtype} {key}: max rel diff {rel:.3e}"
                  + (f" (tol {tol:g})" if held else " (reported)"))
            if held and not rel <= tol:
                raise AssertionError(
                    f"{label} kernel / stencil A/B differ in {key} ({dtype}): "
                    f"{rel}")


def _ibm_fields(solver) -> dict:
    return dict(solver.state["q"], p=solver.state["p"], f=solver.state["f"])


def phase4_ab(tmp: str, solver) -> None:
    """20 steps from the developed flagship state with K1 and with the
    stencil closure (disablePallas); then a small case on the card against
    the plain-PyTorch CPU path."""
    from petibm_tpu_torch.convert import state_to_numpy
    from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver

    def make(name, **params):
        return DecoupledIBPMSolver(flagship_config(os.path.join(tmp, name),
                                                   **params), device=DEVICE)

    _ab("450x450", make, state_to_numpy(solver.state), 20, _ibm_fields)
    _cuda_vs_cpu("32^2", lambda dev, tag: DecoupledIBPMSolver(small_config(
        os.path.join(tmp, f"small_{tag}"), nt=20, dtype="float64"),
        device=dev), ("p", "f"))


def _cuda_vs_cpu(label: str, make, keys) -> dict:
    """A small float64 case on the card (kernels) and on the CPU (twins):
    the fields agree to 1e-9, iteration counts and ok flags are equal.
    Returns the two closed solvers by "card" and "cpu"."""
    runs = {}
    for tag, dev in (("card", DEVICE), ("cpu", "cpu")):
        s = make(dev, tag)
        s.run()
        s.close()
        runs[tag] = s
    for key in keys:
        rel = _rel_err(runs["card"].state[key].cpu(), runs["cpu"].state[key])
        print(f"{label} f64 cuda vs cpu {key}: max rel diff {rel:.3e} "
              "(tol 1e-9)")
        if not rel <= 1e-9:
            raise AssertionError(f"cuda and cpu paths differ in {key}: {rel}")
    streams = {dev: [{k: v for k, v in h.items()
                      if k.endswith(("_iters", "_ok"))}
                     for h in s.stats_history] for dev, s in runs.items()}
    if streams["card"] != streams["cpu"]:
        raise AssertionError("cuda and cpu iteration counts or ok flags differ")
    return runs


def phase5_sphere(tmp: str):
    """The full-size sphere through run(): steps 1-50 warm up, 51-150
    timed; returns (solver, launches)."""
    import numpy as np
    import torch

    from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver

    t0 = time.perf_counter()
    solver = DecoupledIBPMSolver(sphere_config(os.path.join(tmp, "sphere"),
                                               nt=50), device=DEVICE)
    torch.cuda.synchronize()
    print(f"sphere setup {time.perf_counter() - t0:.2f} s: "
          f"{solver.mesh.info()}".replace("\n", "; "))
    print(f"bodies: {solver.bodies.n_pts} points; dtype {solver.dtype}")

    _reset_counts()
    solver.run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.nt = 150
    solver.run()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = _counts()
    solver.close()

    hist = solver.stats_history
    _check_run(hist, 150, "vpf")
    _check_counts("sphere", launches, {
        "K1": sum(2 + s["p_iters"] for s in hist),
        # make_fdm_solver applies A twice, then once per refinement pass
        "K2a": sum(3 * (2 + s["v_iters"]) for s in hist),
        "K2b": 0, "K3": len(hist)})
    st = solver.state
    nx, ny, nz = (sum(sub["cells"] for sub in ax["subDomains"])
                  for ax in solver.config["mesh"])
    _check_fields(dict(st["q"], p=st["p"], f=st["f"]),
                  {"u": (nz, ny, nx - 1), "v": (nz, ny - 1, nx),
                   "w": (nz - 1, ny, nx), "p": (nz, ny, nx),
                   "f": (solver.bodies.n_pts, 3)})
    fx, fy, fz = solver.bodies.avg_forces(st["f"].cpu().numpy())[0]
    area = np.pi / 4  # frontal area of the unit-diameter sphere
    last = hist[-1]
    print(f"sphere {elapsed / 100 * 1e3:.3f} ms/step over steps 51-150 "
          f"(synchronised); last step v/p/f iters {last['v_iters']}/"
          f"{last['p_iters']}/{last['f_iters']}; t = {solver.t:.4f}: "
          f"Cd {2 * fx / area:.5f}, Cl {2 * math.hypot(fy, fz) / area:.5f}")
    return solver, launches


def _energy(q: dict) -> float:
    """Volume-averaged kinetic energy on the uniform periodic box."""
    return 0.5 * sum(float(a.double().pow(2).mean()) for a in q.values())


def phase6_tgv(tmp: str):
    """The 256^3 TGV through run(): 20 steps in chunks of 5 after the
    first, the energy read between chunks; returns (solver, launches)."""
    import torch

    from petibm_tpu_torch.solvers.navierstokes import NavierStokesSolver

    t0 = time.perf_counter()
    solver = NavierStokesSolver(tgv3d_config(os.path.join(tmp, "tgv"), nt=1),
                                device=DEVICE)
    tgv3d_initial_state(solver)
    torch.cuda.synchronize()
    print(f"tgv setup {time.perf_counter() - t0:.2f} s: {solver.mesh.info()}"
          .replace("\n", "; "))
    energies = [_energy(solver.state["q"])]
    _reset_counts()
    solver.run()
    energies.append(_energy(solver.state["q"]))
    elapsed = 0.0
    for nt in (5, 10, 15, 20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.nt = nt
        solver.run()
        torch.cuda.synchronize()
        elapsed += time.perf_counter() - t0
        energies.append(_energy(solver.state["q"]))
    launches = _counts()
    solver.close()

    hist = solver.stats_history
    _check_run(hist, 20, "vp")
    _check_counts("tgv256", launches, {
        "K1": 0,
        # BiCGStab applies A once, then twice per iteration
        "K2a": sum(3 * (1 + 2 * s["v_iters"]) for s in hist),
        "K2b": sum(2 + s["p_iters"] for s in hist),
        "K3": len(hist)})
    st = solver.state
    n = solver.mesh.shape(0)
    _check_fields(dict(st["q"], p=st["p"]),
                  {"u": n, "v": n, "w": n, "p": n})
    print("tgv256 kinetic energy after steps 0, 1, 5, 10, 15, 20: "
          + ", ".join(f"{e:.8f}" for e in energies))
    if any(b > a for a, b in zip(energies, energies[1:])):
        raise AssertionError(f"kinetic energy grew: {energies}")
    last = hist[-1]
    print(f"tgv256 {elapsed / 19 * 1e3:.3f} ms/step over steps 2-20 "
          f"(synchronised); last step v/p iters {last['v_iters']}/"
          f"{last['p_iters']}; t = {solver.t:.4f}")
    return solver, launches


def phase7_ab3d(tmp: str, sphere, tgv) -> None:
    """10 sphere steps and 5 TGV steps from the developed states with the
    kernels on and off, in float64 and float32; then a 16^3 TGV on the
    card against the plain-PyTorch CPU path."""
    from petibm_tpu_torch.convert import state_to_numpy
    from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver
    from petibm_tpu_torch.solvers.navierstokes import NavierStokesSolver

    def make_sphere(name, **params):
        return DecoupledIBPMSolver(sphere_config(os.path.join(tmp, name),
                                                 **params), device=DEVICE)

    def make_tgv(name, **params):
        return NavierStokesSolver(tgv3d_config(os.path.join(tmp, name),
                                               **params), device=DEVICE)

    # float32 at 1e-4, the CPU tests' float32 tolerance: the sphere's force
    # blocks (1963 points, condition ~450) lift the velocity's rounding
    # differences (~2e-6) to ~1e-5 in the forces
    _ab("sphere", make_sphere, state_to_numpy(sphere.state), 10, _ibm_fields,
        f32_tol=1e-4)
    _ab("tgv256", make_tgv, state_to_numpy(tgv.state), 5,
        lambda s: dict(s.state["q"], p=s.state["p"]), f32_tol=1e-4)

    def small(dev, tag):
        s = NavierStokesSolver(tgv3d_config(os.path.join(tmp, f"tgv16_{tag}"),
                                            n=16, nt=10, dt=0.05,
                                            dtype="float64"), device=dev)
        tgv3d_initial_state(s)
        return s

    _cuda_vs_cpu("tgv 16^3", small, ("p",))


def _busy_share(solver, steps: int = 5) -> tuple:
    """Device busy share over ``steps`` more steps, with the wall and
    device ms per step (torch.profiler; only the device-side events count:
    the operators that launch them carry the same time again).  The
    profiler's raw events are summed: ``key_averages()`` takes about a
    millisecond an event to build, a minute for one step of a Krylov
    force solve."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    solver.nt += steps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA) / 1e3
    return busy_us / wall_us, wall_us / steps / 1e3, busy_us / steps / 1e3


def _mg_counts(solver, level0_per_vcycle: int = 2) -> dict:
    """The launches of the MG-CG pressure solve the stats imply: one
    V-cycle per CG iteration and one more, each of sweeps_per_vcycle()
    line sweeps (K4/K5 on a non-periodic grid, K6/K7 on a periodic one),
    and the level-0 operator (K1 or K2b) twice per V-cycle (the CG
    operator, A(x0) and one per iteration, and the V-cycle's residual);
    once in the coupled IBPM, whose CG operator is not K1."""
    hist = solver.stats_history
    vcycles = sum(1 + s["p_iters"] for s in hist)
    sweeps = solver.poisson_mg.sweeps_per_vcycle() * vcycles
    if any(solver.mesh.periodic):
        return {"K6/K7": sweeps, "K2b": level0_per_vcycle * vcycles}
    return {"K4/K5": sweeps, "K1": level0_per_vcycle * vcycles}


def _report_mg(label: str, solver, elapsed: float, nsteps: int,
               extra: str = "", profile_steps: int = 5) -> None:
    """ms/step and p_iters of the run, then a profile of ``profile_steps``
    more steps (the profiler's post-processing grows with the events:
    a coupled step of ~150 V-cycles takes one)."""
    hist = solver.stats_history
    p_iters = [s["p_iters"] for s in hist]
    busy, wall_ms, device_ms = _busy_share(solver, profile_steps)
    print(f"{label} {elapsed / nsteps * 1e3:.3f} ms/step over the last "
          f"{nsteps} steps (synchronised); p_iters mean "
          f"{statistics.mean(p_iters):.2f}, last {p_iters[-1]}, max "
          f"{max(p_iters)}; {len(solver.poisson_mg.levels)} MG levels, "
          f"{solver.poisson_mg.sweeps_per_vcycle()} sweeps per V-cycle"
          + extra)
    window = [s["p_iters"] for s in solver.stats_history[len(p_iters):]]
    # one V-cycle per CG iteration and one more: device time follows them
    vcycles = statistics.mean(window) + 1
    print(f"{label} profile of {profile_steps} more steps: "
          f"{wall_ms:.3f} ms/step wall, "
          f"{device_ms:.3f} ms/step device, busy share {busy:.4f}; "
          f"p_iters {window}: {device_ms / vcycles:.3f} ms device per "
          "V-cycle")


def _timed_run(solver, warm: int, total: int) -> float:
    """run() to ``warm`` steps, then on to ``total`` timed; the seconds of
    the timed part."""
    import torch

    solver.nt = warm
    solver.run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.nt = total
    solver.run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase8_mg(tmp: str) -> tuple:
    """The three cells with ``fdm: false`` through run(): the flagship (20
    warm-up + 100 timed steps), the sphere (5 + 15), the 256^3 TGV (10 in
    chunks, the energy read between them); every launch count against the
    stats.  Returns the three solvers and the launches of each run."""
    import numpy as np
    import torch

    from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver
    from petibm_tpu_torch.solvers.navierstokes import NavierStokesSolver

    counts = []
    # the 450^2 flagship: K4/K5 on every level, K1
    flag = DecoupledIBPMSolver(flagship_config(os.path.join(tmp, "mg_flag"),
                                               fdm=False), device=DEVICE)
    _reset_counts()
    elapsed = _timed_run(flag, 20, 120)
    counts.append(_counts())
    _check_run(flag.stats_history, 120, "vpf")
    _check_counts("flagship mg", counts[-1], _mg_counts(flag))
    st = flag.state
    _check_fields({"p": st["p"], "f": st["f"]},
                  {"p": flag.mesh.shape(3), "f": (flag.bodies.n_pts, 2)})
    fx, fy = flag.bodies.avg_forces(st["f"].cpu().numpy())[0]
    _report_mg("flagship mg", flag, elapsed, 100,
               f"; t = {flag.t:.4f}: Cd {2 * fx:.5f}, Cl {2 * fy:.5f}")

    # the sphere: 3D K4/K5, K1, BiCGStab on K2a, K3
    sph = DecoupledIBPMSolver(sphere_config(os.path.join(tmp, "mg_sphere"),
                                            fdm=False), device=DEVICE)
    _reset_counts()
    elapsed = _timed_run(sph, 5, 20)
    counts.append(_counts())
    _check_run(sph.stats_history, 20, "vpf")
    hist = sph.stats_history
    _check_counts("sphere mg", counts[-1], dict(
        _mg_counts(sph), K2a=sum(3 * (1 + 2 * s["v_iters"]) for s in hist),
        K3=len(hist)))
    st = sph.state
    _check_fields(dict(st["q"], p=st["p"]),
                  {k: sph.mesh.shape(f) for f, k in enumerate("uvwp")})
    fx, fy, fz = sph.bodies.avg_forces(st["f"].cpu().numpy())[0]
    _report_mg("sphere mg", sph, elapsed, 15,
               f"; t = {sph.t:.4f}: Cd {2 * fx / (np.pi / 4):.5f}")

    # the 256^3 TGV: K6/K7 on every level, K2b, BiCGStab on K2a, K3
    tgv = NavierStokesSolver(tgv3d_config(os.path.join(tmp, "mg_tgv"), nt=1,
                                          fdm=False), device=DEVICE)
    tgv3d_initial_state(tgv)
    energies = [_energy(tgv.state["q"])]
    _reset_counts()
    tgv.run()
    energies.append(_energy(tgv.state["q"]))
    elapsed = 0.0
    for nt in (4, 7, 10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tgv.nt = nt
        tgv.run()
        torch.cuda.synchronize()
        elapsed += time.perf_counter() - t0
        energies.append(_energy(tgv.state["q"]))
    counts.append(_counts())
    hist = tgv.stats_history
    _check_run(hist, 10, "vp")
    _check_counts("tgv256 mg", counts[-1], dict(
        _mg_counts(tgv), K2a=sum(3 * (1 + 2 * s["v_iters"]) for s in hist),
        K3=len(hist)))
    _check_fields(dict(tgv.state["q"], p=tgv.state["p"]),
                  {k: tgv.mesh.shape(0) for k in "uvwp"})
    print("tgv256 mg kinetic energy after steps 0, 1, 4, 7, 10: "
          + ", ".join(f"{e:.8f}" for e in energies))
    if any(b > a for a, b in zip(energies, energies[1:])):
        raise AssertionError(f"kinetic energy grew: {energies}")
    _report_mg("tgv256 mg", tgv, elapsed, 9)
    for solver in (flag, sph, tgv):
        solver.close()
    return (flag, sph, tgv), counts


def phase9_mg_ab(tmp: str, flag, sph, tgv) -> None:
    """The MG-CG paths with the kernels on and off from their developed
    states (float64 to 1e-10 with equal iteration counts, float32 to
    1e-4), then small MG-CG cases on the card against the CPU path."""
    from petibm_tpu_torch.convert import state_to_numpy
    from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver
    from petibm_tpu_torch.solvers.navierstokes import NavierStokesSolver

    def make(config, cls):
        def make_solver(name, **params):
            return cls(config(os.path.join(tmp, name), fdm=False, **params),
                       device=DEVICE)
        return make_solver

    _ab("450x450 mg", make(flagship_config, DecoupledIBPMSolver),
        state_to_numpy(flag.state), 4, _ibm_fields, f32_tol=1e-4,
        f64_tol=1e-10, same_iters=True)
    _ab("sphere mg", make(sphere_config, DecoupledIBPMSolver),
        state_to_numpy(sph.state), 5, _ibm_fields, f32_tol=1e-4,
        f64_tol=1e-10, same_iters=True)
    _ab("tgv256 mg", make(tgv3d_config, NavierStokesSolver),
        state_to_numpy(tgv.state), 2,
        lambda s: dict(s.state["q"], p=s.state["p"]), f32_tol=1e-4,
        f64_tol=1e-10, same_iters=True)
    _cuda_vs_cpu("32^2 mg", lambda dev, tag: DecoupledIBPMSolver(small_config(
        os.path.join(tmp, f"small_mg_{tag}"), nt=20, dtype="float64",
        fdm=False), device=dev), ("p", "f"))

    def small_tgv(dev, tag):
        s = NavierStokesSolver(tgv3d_config(
            os.path.join(tmp, f"tgv16_mg_{tag}"), n=16, nt=10, dt=0.05,
            dtype="float64", fdm=False), device=dev)
        tgv3d_initial_state(s)
        return s

    _cuda_vs_cpu("tgv 16^3 mg", small_tgv, ("p",))


def kl_compare(t, cd) -> dict:
    """Cd(t) against Koumoutsakos & Leonard (1995) at Re=550 over t in
    [0.5, t_final]: the published time U t / R halved to U t / D, the
    simulated curve interpolated at the published samples (the comparison
    of scripts/validate_forces.py:_kl_curve_compare, unrounded)."""
    import numpy as np

    tp, cdp = np.loadtxt(KL_RE550, unpack=True)
    tp = 0.5 * tp
    sel = (tp >= 0.5) & (tp <= t[-1] + 1e-9)
    dev = np.interp(tp[sel], t, cd) - cdp[sel]
    rms, worst = float(np.sqrt(np.mean(dev ** 2))), float(np.abs(dev).max())
    return {"n_published_samples": int(sel.sum()),
            "t_range_compared": [float(tp[sel][0]), float(tp[sel][-1])],
            "rms_dev": rms, "max_abs_dev": worst,
            "pass": rms <= KL_RMS and worst <= KL_MAX}


def re550_run(out: str, pinned: bool, warm: int = 100) -> tuple:
    """examples/ibpm/cylinder2dRe550 (``pinned``: _GPU) through
    ``IBPMSolver.run()``: steps 1 to ``warm``, then on to 1200 (t = 3)
    timed; every solve converged; Cd(t) from the forces log against K&L.
    Returns (the open solver, its record, the launches of the run)."""
    import numpy as np
    import torch

    from petibm_tpu_torch.solvers.ibpm import IBPMSolver

    t0 = time.perf_counter()
    solver = IBPMSolver(re550_config(out, pinned), device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    _reset_counts()
    elapsed = _timed_run(solver, warm, 1200)
    launches = _counts()
    hist = solver.stats_history
    _check_run(hist, 1200, "vp")
    st = solver.state
    _check_fields({"u": st["q"]["u"], "v": st["q"]["v"], "p": st["p"],
                   "f": st["f"]},
                  {"u": solver.mesh.shape(0), "v": solver.mesh.shape(1),
                   "p": solver.mesh.shape(3), "f": (solver.bodies.n_pts, 2)})
    forces = np.loadtxt(os.path.join(solver.output_dir, "forces-0.txt"),
                        ndmin=2)
    if forces.shape != (1200, 3):
        raise AssertionError(f"forces log has shape {forces.shape}")
    t, cd = forces[:, 0], 2 * forces[:, 1]
    p_iters = [s["p_iters"] for s in hist]
    record = {"case": "cylinder2dRe550" + ("_GPU" if pinned else ""),
              "solver": "IBPMSolver", "pressure": ("pinned" if pinned
                                                   else "mean projection"),
              "coupled_solve": "CG preconditioned by the Schur solve",
              "grid": "x".join(str(n) for n in solver.mesh.shape(3)),
              "body_points": solver.bodies.n_pts,
              "dtype": "float32", "steps": len(hist), "t_final": float(t[-1]),
              "cd_final": float(cd[-1]),
              "setup_s": setup_s,
              "ms_per_step": elapsed / (1200 - warm) * 1e3,
              "timed_steps": [warm + 1, 1200],
              "p_iters_mean": statistics.mean(p_iters),
              "p_iters_max": max(p_iters),
              "v_iters_mean": statistics.mean(s["v_iters"] for s in hist),
              "curve_vs_koumoutsakos_leonard_1995": kl_compare(t, cd)}
    return solver, record, launches


def phase10_coupled(tmp: str) -> list:
    """The coupled IBPM through ``IBPMSolver.run()``: (a) Re=550 and (b)
    its pinned-pressure twin to t = 3 against the K&L curve (the Schur CG:
    2D, no hand kernel in its path); (c) Re=550 with ``fdm: false`` (CG on
    the coupled system with the V-cycle: K1 at its level-0 residual, the
    K4/K5 sweeps), 5 steps with the launches against the stats, one step
    A/B'd with the kernels off; (d) small 2D and 3D (K2a, K3) coupled
    cases on the card against the CPU.  Returns the launches of each
    run."""
    from petibm_tpu_torch.convert import state_to_numpy
    from petibm_tpu_torch.solvers.ibpm import IBPMSolver

    t0 = time.perf_counter()

    def part(name: str) -> None:
        print(f"phase 10 {name} done at {time.perf_counter() - t0:.1f} s "
              "into the phase")

    counts = []
    for label, pinned in (("re550", False), ("re550_GPU", True)):
        solver, record, launches = re550_run(os.path.join(tmp, label),
                                             pinned)
        counts.append(launches)
        _check_counts(label, launches, {})
        busy, wall_ms, device_ms = _busy_share(solver)
        solver.close()
        record["profile_5_steps"] = {"wall_ms_per_step": wall_ms,
                                     "device_ms_per_step": device_ms,
                                     "device_busy_share": busy}
        print(json.dumps({"coupled": record}))
        cmp = record["curve_vs_koumoutsakos_leonard_1995"]
        if not cmp["pass"]:
            raise AssertionError(
                f"{label}: Cd(t) off the K&L curve, rms {cmp['rms_dev']} "
                f"(<= {KL_RMS}), max {cmp['max_abs_dev']} (<= {KL_MAX})")
        part(label)

    # (c) the outer CG with the V-cycle
    def make_mg(name, **params):
        return IBPMSolver(re550_config(os.path.join(tmp, name), fdm=False,
                                       **params), device=DEVICE)

    mg = make_mg("re550_mg")
    if mg.poisson_mg._fused_apply0 is None:
        raise AssertionError("re550 mg: K1 is not the V-cycle's level 0")
    _reset_counts()
    elapsed = _timed_run(mg, 1, 5)
    counts.append(_counts())
    _check_run(mg.stats_history, 5, "vp")
    _check_counts("re550 mg", counts[-1], _mg_counts(mg, 1))
    _report_mg("re550 mg", mg, elapsed, 4, profile_steps=1)
    mg.close()
    part("re550 mg")
    _ab("re550 mg", make_mg, state_to_numpy(mg.state), 1, _ibm_fields,
        f32_tol=1e-4, f64_tol=1e-10, same_iters=True)
    part("re550 mg A/B")

    # (d) small cases, card against CPU
    _reset_counts()
    _cuda_vs_cpu("32^2 coupled", lambda dev, tag: IBPMSolver(small_config(
        os.path.join(tmp, f"small_ibpm_{tag}"), nt=20, dtype="float64"),
        device=dev), ("p", "f"))
    _check_counts("32^2 coupled", _counts(), {})
    _reset_counts()
    runs = _cuda_vs_cpu("24x20x16 coupled", lambda dev, tag: IBPMSolver(
        small3d_config(os.path.join(tmp, f"small3d_ibpm_{tag}"), nt=5,
                       dtype="float64"), device=dev), ("p", "f"))
    counts.append(_counts())
    hist = runs["card"].stats_history
    _check_counts("24x20x16 coupled", counts[-1], {
        # make_fdm_solver applies A twice, then once per refinement pass
        "K2a": sum(3 * (2 + s["v_iters"]) for s in hist), "K3": len(hist)})
    part("cuda vs cpu")
    return counts


def phase11_moving(tmp: str) -> list:
    """The oscillating cylinder through ``RigidKinematicsSolver.run()``:
    steps 1-100, then 101-600 timed, K1 against the stats, the forces, the
    fallbacks, a profile of 5 more steps; the window recompute timed, and
    the same case with its body held still (``DecoupledIBPMSolver``, 100
    + 100 steps) for its ms/step; then a small float64 moving body on the
    card against the CPU.  Returns the launches of the two card runs."""
    import numpy as np
    import torch

    from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver
    from petibm_tpu_torch.solvers.rigidkinematics import RigidKinematicsSolver

    t0 = time.perf_counter()
    solver = RigidKinematicsSolver(oscillating_config(
        os.path.join(tmp, "osc"), nt=600), device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    _reset_counts()
    elapsed = _timed_run(solver, 100, 600)
    counts = [_counts()]
    hist = solver.stats_history
    _check_run(hist, 600, "vpf")
    _check_counts("oscillating", counts[0],
                  {"K1": sum(2 + s["p_iters"] for s in hist)})
    st = solver.state
    _check_fields({"u": st["q"]["u"], "v": st["q"]["v"], "p": st["p"],
                   "f": st["f"]},
                  {"u": solver.mesh.shape(0), "v": solver.mesh.shape(1),
                   "p": solver.mesh.shape(3), "f": (solver.bodies.n_pts, 2)})
    forces = np.loadtxt(os.path.join(solver.output_dir, "forces-0.txt"),
                        ndmin=2)
    if forces.shape != (600, 3) or not np.isfinite(forces).all():
        raise AssertionError(f"oscillating: forces log of shape "
                             f"{forces.shape}, or not finite")
    fx = forces[:, 1]
    f_iters = [s["f_iters"] for s in hist]
    # nsave 100: where h5py imports, five snapshots fall in the timed steps
    snapshots = sum(os.path.exists(os.path.join(solver.output_dir,
                                                f"{ite:07d}.h5"))
                    for ite in range(101, 601))
    print(f"oscillating: {snapshots} HDF5 snapshots written in the timed "
          f"steps 101-600 (h5py {'imports' if solver.hdf5 else 'absent'})")
    print(f"oscillating: setup {setup_s:.3f} s; "
          f"{elapsed / 500 * 1e3:.3f} ms/step over steps 101-600 "
          f"(synchronised); t = {solver.t:.4f}, state t "
          f"{float(st['t']):.6f}; in-line force Fx {fx[-1]:.5f} (max |Fx| "
          f"{np.abs(fx).max():.5f}), Fy {forces[-1, 2]:.3e}; "
          f"force solve: {solver.fallbacks} fallbacks to the dense solve in "
          f"600 steps, f_iters mean {statistics.mean(f_iters):.3f}, max "
          f"{max(f_iters)}; p_iters mean "
          f"{statistics.mean(s['p_iters'] for s in hist):.3f}, v_iters mean "
          f"{statistics.mean(s['v_iters'] for s in hist):.3f}")
    nsteps = len(hist)
    # ~3.5 ms of host time a call: batches of 4 stay inside _time_ms's
    # 25 ms spin, so the device number is the windows' own
    windows_ms = _time_ms(solver._windows, st, applies=100, batch=4)
    busy, wall_ms, device_ms = _busy_share(solver)
    print(f"oscillating profile of 5 more steps: {wall_ms:.3f} ms/step "
          f"wall, {device_ms:.3f} ms/step device, busy share {busy:.4f}; "
          f"window recompute (coordinates and the delta windows) "
          f"{windows_ms[0]:.4f} ms device, {windows_ms[1]:.4f} ms host "
          "a step")
    solver.close()

    still_cfg = oscillating_config(os.path.join(tmp, "osc_still"), nt=100)
    del still_cfg["bodies"][0]["kinematics"]
    still = DecoupledIBPMSolver(still_cfg, device=DEVICE)
    still_s = _timed_run(still, 100, 200)
    _check_run(still.stats_history, 200, "vpf")
    busy_s, wall_s, device_s = _busy_share(still)
    still.close()
    print(f"oscillating case, body held still: {still_s / 100 * 1e3:.3f} "
          f"ms/step over steps 101-200; profile of 5 more steps: "
          f"{wall_s:.3f} ms/step wall, {device_s:.3f} device, busy share "
          f"{busy_s:.4f}")
    print(json.dumps({"moving": {
        "case": "oscillatingcylinder2dRe100", "solver":
        "RigidKinematicsSolver", "grid": "x".join(
            str(n) for n in solver.mesh.shape(3)), "body_points":
        solver.bodies.n_pts, "dtype": "float32", "steps": nsteps,
        "setup_s": setup_s, "ms_per_step": elapsed / 500 * 1e3,
        "timed_steps": [101, 600], "hdf5_snapshots_timed": snapshots,
        "fallbacks": solver.fallbacks,
        "f_iters_mean": statistics.mean(f_iters),
        "profile_5_steps": {"wall_ms_per_step": wall_ms,
                            "device_ms_per_step": device_ms,
                            "device_busy_share": busy},
        "window_recompute_ms": {"device": windows_ms[0],
                                "host": windows_ms[1]},
        "still_body_ms_per_step": still_s / 100 * 1e3,
        "still_body_profile_5_steps": {"wall_ms_per_step": wall_s,
                                       "device_ms_per_step": device_s,
                                       "device_busy_share": busy_s}}}))

    def small(dev, tag):
        cfg = small_config(os.path.join(tmp, f"small_osc_{tag}"), nt=20,
                           dtype="float64")
        cfg["bodies"][0]["kinematics"] = {"type": "oscillation", "f": 1.0,
                                          "D": 1.0, "KC": 2.0}
        return RigidKinematicsSolver(cfg, device=dev)

    _reset_counts()
    runs = _cuda_vs_cpu("32^2 moving", small, ("p", "f"))
    counts.append(_counts())
    card, cpu = runs["card"], runs["cpu"]
    _check_counts("32^2 moving", counts[-1], {
        "K1": sum(2 + s["p_iters"] for s in card.stats_history)})
    if not torch.equal(card.state["t"].cpu(), cpu.state["t"]):
        raise AssertionError("32^2 moving: the step's time differs")
    print(f"32^2 moving: {card.fallbacks} fallbacks on the card, "
          f"{cpu.fallbacks} on the CPU")
    if card.fallbacks != cpu.fallbacks:
        raise AssertionError("32^2 moving: the fallbacks differ")
    return counts


#: the stage profiler's phase names, as the JAX package's _profile_phases
#: gives them (navierstokes.py:698-702, decoupledibpm.py:320-328)
JAX_PHASES = {
    "navierstokes": ("rhsVelocity", "solveVelocity", "rhsPoisson",
                     "solvePoisson", "update"),
    "decoupledibpm": ("moveIB", "rhsVelocity", "solveVelocity", "rhsForces",
                      "solveForces", "applyNoSlip", "rhsPoisson",
                      "solvePoisson", "update"),
}
#: the refined sphere's body spacing: the inner box's cell width, 1.2 / 90
REFINED_DS = 1.2 / 90


def refined_sphere_config(tmp: str, **params) -> dict:
    """``sphere_config`` with the inner box [-0.6, 0.6]^3 refined to 90
    cells (h = 1.2 / 90 = 0.013333): the outer subdomains keep their cell
    counts and ends, their stretch ratios become 0.912 upstream, 1.061
    downstream in x and 1.097 in y and z, so the cells next to the box are
    0.0140, 0.0132 and 0.0138; 220x190x190 cells.  The body is
    ``scripts/make_sphere_body.py --ds h`` (17 671 points), built in
    ``tmp``."""
    cfg = sphere_config(tmp, **params)
    for ax, ratio_hi in zip(cfg["mesh"], (1.061, 1.097, 1.097)):
        lo, box, hi = ax["subDomains"]
        lo["stretchRatio"] = 0.912
        box["cells"] = 90
        hi["stretchRatio"] = ratio_hi
    body = os.path.join(tmp, "sphere.body")
    subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                 "make_sphere_body.py"),
                    body, "--ds", repr(REFINED_DS)], check=True,
                   capture_output=True, timeout=120)
    cfg["bodies"] = [{"type": "points", "file": body}]
    return cfg


def _engines_ab(label: str, mesh, X, dtype, tol, applies: int = 0,
                budgets: tuple = ()) -> dict:
    """The windowed delta engine's E and H against the factor engine's on
    one body's windows (seeded fields and forces), within ``tol`` of the
    factor result's maximum; with ``applies``, each engine's E and H
    timed (device and host ms per apply, median), the windowed engine at
    the card's chunk budget and at each of ``budgets`` (bytes)."""
    import torch

    from petibm_tpu_torch.ibm.interp import DeltaOp, WindowedDeltaOp

    cuda = torch.device(DEVICE)
    gen = torch.Generator(device=cuda).manual_seed(12)
    kw = dict(dtype=dtype, device=cuda)
    X = X.to(dtype)
    engines = {"factor": DeltaOp(mesh, **kw)}
    for budget in (WindowedDeltaOp._chunk_budget,) + tuple(budgets):
        op = WindowedDeltaOp(mesh, **kw)
        op._chunk_budget = budget
        engines[f"windowed {budget >> 20} MB"] = op
    t0 = time.perf_counter()
    wins = {}
    for name, op in engines.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wins[name] = op.windows(X)
        torch.cuda.synchronize()
        print(f"{label} {name} windows built in "
              f"{(time.perf_counter() - t0) * 1e3:.2f} ms (host clock, "
              f"synchronised)")
    q = {k: torch.randn(mesh.shape(c), generator=gen, **kw)
         for c, k in enumerate("uvw"[:mesh.dim])}
    f = torch.randn((X.shape[0], mesh.dim), generator=gen, **kw)
    want_e = engines["factor"].interpolate(q, wins["factor"])
    want_h = engines["factor"].spread(f, wins["factor"])
    out = {}
    for name, op in engines.items():
        if name == "factor":
            continue
        win = wins[name]
        err_e = _rel_err(op.interpolate(q, win), want_e)
        got_h = op.spread(f, win)
        err_h = max(_rel_err(got_h[k], want_h[k]) for k in want_h)
        chunks = [-(-X.shape[0] // op._chunk_size(win[c]))
                  for c in range(mesh.dim)]
        print(f"{label} {name} vs factor ({str(dtype)[6:]}, {X.shape[0]} "
              f"points, window boxes "
              + ", ".join("x".join(str(h - lo) for lo, h in zip(
                  win[c]["lo"], win[c]["hi"])) for c in range(mesh.dim))
              + f", chunks {chunks}): E rel {err_e:.3e}, H rel "
              f"{err_h:.3e} (tol {tol:g})")
        if not (err_e <= tol and err_h <= tol):
            raise AssertionError(f"{label}: the windowed engine differs "
                                 f"from the factor engine: {err_e}, {err_h}")
        out[name] = {"E_rel": err_e, "H_rel": err_h, "chunks": chunks}
    if applies:
        for name, op in engines.items():
            win = wins[name]
            e_ms = _time_ms(lambda a: op.interpolate(a, win), q, applies,
                            batch=2)
            h_ms = _time_ms(lambda a: op.spread(a, win), f, applies,
                            batch=2)
            print(f"{label} {name} ({str(dtype)[6:]}): E {e_ms[0]:.3f} ms "
                  f"device, {e_ms[1]:.3f} ms host; H {h_ms[0]:.3f} ms "
                  f"device, {h_ms[1]:.3f} ms host (median per apply)")
            out.setdefault(name, {}).update(
                E_ms=e_ms[0], E_host_ms=e_ms[1], H_ms=h_ms[0],
                H_host_ms=h_ms[1])
    return out


def _chained_equals_step(label: str, solver) -> None:
    """The profiler's phases chained once equal one production step bit
    for bit on the card, from the solver's state; the phase names are the
    JAX package's."""
    import torch

    from petibm_tpu_torch.utils.profiling import chain_phases

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, (tuple, list)):
            return [x for v in tree for x in leaves(v)]
        return [tree]

    phases = solver._profile_phases()
    kind = ("decoupledibpm" if hasattr(solver, "delta") else "navierstokes")
    names = tuple(n for n, _ in phases)
    if names != JAX_PHASES[kind]:
        raise AssertionError(f"{label}: phases {names} != JAX's "
                             f"{JAX_PHASES[kind]}")
    chained = leaves(chain_phases(phases, solver.state)["state"])
    stepped = leaves(solver._step_fn(solver.state)[0])
    same = len(chained) == len(stepped) and all(
        torch.equal(a, b) for a, b in zip(chained, stepped))
    print(f"{label}: the {len(names)} phases chained equal the production "
          f"step bit for bit ({len(stepped)} state tensors): {same}")
    if not same:
        raise AssertionError(f"{label}: chained phases differ from the step")


def _profile_table(label: str, solver) -> dict:
    """``profile_stages(steps=5)`` and its table, printed."""
    result = solver.profile_stages(steps=5)
    path = os.path.join(solver.logs_dir, f"stages-{solver.ite}.txt")
    print(f"{label} stage table (profile_stages(steps=5), {path}):")
    with open(path) as fh:
        print(fh.read().rstrip())
    return result


def phase12_windowed(tmp: str) -> list:
    """The windowed delta engine with the Krylov force solve, probes,
    vorticity and the stage profiler: (a) the sphere with ``deltaEngine:
    windowed``, (b) the 17 671-point refined sphere (``auto`` picks the
    windowed engine), (c) the flagship with a point and a volume probe,
    and the vorticity on the card against the CPU, (d) the stage profiler
    on the flagship and on (a).  Returns the launches of the runs of
    (a), (b) and (c)."""
    import numpy as np
    import torch

    from petibm_tpu_torch.io.vorticity import compute_vorticity
    from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver

    t_phase = time.perf_counter()

    def part(name: str) -> None:
        print(f"phase 12 {name} done at "
              f"{time.perf_counter() - t_phase:.1f} s into the phase")

    counts = []

    def sphere_counts(hist):
        return {"K1": sum(2 + s["p_iters"] for s in hist),
                "K2a": sum(3 * (2 + s["v_iters"]) for s in hist),
                "K3": len(hist)}

    # (a) the sphere through the windowed engine and the CG force solve
    sph = DecoupledIBPMSolver(sphere_config(
        os.path.join(tmp, "win_sphere"), nt=5, deltaEngine="windowed"),
        device=DEVICE)
    if not sph.delta.windowed or sph._dense_forces(sph._fopts):
        raise AssertionError("sphere (a): not the windowed Krylov path")
    coords = torch.as_tensor(sph.bodies.all_coords(), device=DEVICE)
    _engines_ab("sphere (a)", sph.mesh, coords, torch.float64, 1e-12)
    _engines_ab("sphere (a)", sph.mesh, coords, torch.float32, 1e-5,
                applies=20)
    _reset_counts()
    t0 = time.perf_counter()
    sph.run()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts.append(_counts())
    hist = sph.stats_history
    _check_run(hist, 5, "vpf")
    _check_counts("sphere (a) windowed", counts[-1], sphere_counts(hist))
    busy, wall_ms, device_ms = _busy_share(sph, 2)
    print(f"sphere (a) windowed, CG force solve (atol "
          f"{sph._fopts['atol']:g}, no preconditioner): "
          f"{elapsed / 5 * 1e3:.3f} ms/step over 5 steps (synchronised); "
          f"f_iters {[s['f_iters'] for s in hist]}, p_iters "
          f"{[s['p_iters'] for s in hist]}, v_iters "
          f"{[s['v_iters'] for s in hist]}; profile of 2 more steps: "
          f"{wall_ms:.3f} ms/step wall, {device_ms:.3f} device, busy share "
          f"{busy:.4f}")
    part("(a)")

    # (b) the design scale: 17 671 points, auto picks the windowed engine;
    # its peak memory counted above what earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    big = DecoupledIBPMSolver(refined_sphere_config(
        os.path.join(tmp, "refined"), nt=3), device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    shape = tuple(big.mesh.shape(3))
    n_pts = int(round(4.0 * math.pi * 0.25 / REFINED_DS ** 2))
    if big.bodies.n_pts != n_pts or not big.delta.windowed:
        raise AssertionError(f"refined sphere: {big.bodies.n_pts} points, "
                             f"windowed {big.delta.windowed}")
    X = torch.as_tensor(big.bodies.all_coords(), dtype=big.dtype,
                        device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big.delta.windows(X)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    print(f"refined sphere: {shape[::-1]} cells, {big.bodies.n_pts} points, "
          f"setup {setup_s:.3f} s, the window build alone {window_s * 1e3:.3f}"
          f" ms (host clock, synchronised)")
    _reset_counts()
    t0 = time.perf_counter()
    big.nt = 1
    big.run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    # 5 steps in all, 3 of them warm-up; 2 (1 warm-up) where the first
    # takes more than 3 s
    warm, total = (3, 5) if first_s <= 3.0 else (1, 2)
    big.nt = warm
    big.run()
    t0 = time.perf_counter()
    big.nt = total
    big.run()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    nsteps = total - warm
    counts.append(_counts())
    hist = big.stats_history
    _check_run(hist, total, "vpf")
    _check_counts("refined sphere", counts[-1], sphere_counts(hist))
    peak = torch.cuda.max_memory_allocated() - held
    busy, wall_ms, device_ms = _busy_share(big, 1)
    st = big.state
    nz, ny, nx = shape
    _check_fields(dict(st["q"], p=st["p"], f=st["f"]),
                  {"u": (nz, ny, nx - 1), "v": (nz, ny - 1, nx),
                   "w": (nz - 1, ny, nx), "p": (nz, ny, nx),
                   "f": (big.bodies.n_pts, 3)})
    fx, fy, fz = big.bodies.avg_forces(st["f"].cpu().numpy())[0]
    f_iters = [s["f_iters"] for s in hist]
    print(f"refined sphere: {elapsed / nsteps * 1e3:.3f} ms/step over steps "
          f"{warm + 1}-{total} (synchronised; step 1 {first_s:.3f} s); "
          f"f_iters {f_iters}, p_iters {[s['p_iters'] for s in hist]}, "
          f"v_iters {[s['v_iters'] for s in hist]}; peak device memory "
          f"{peak / 2**30:.3f} GiB above the {held / 2**30:.3f} GiB held "
          f"before it; profile of 1 more step: "
          f"{wall_ms:.3f} ms wall, {device_ms:.3f} ms device, busy share "
          f"{busy:.4f}; t = {big.t:.4f}: Cd {2 * fx / (np.pi / 4):.5f}")
    part("(b) run")
    ab = _engines_ab("refined sphere", big.mesh, X, torch.float32, 1e-5,
                     applies=6, budgets=(128 << 20,))
    part("(b) E/H A/B")
    kernels = _hold_at_shape(big, applies=40)
    for key, rec in kernels.items():
        rec["launches_per_step"] = counts[-1][key] / total
    part("(b) kernels")
    print(json.dumps({"windowed": {
        "case": "sphere3dRe300 refined to h 0.013333", "grid": "x".join(
            str(n) for n in shape[::-1]), "body_points": big.bodies.n_pts,
        "dtype": "float32", "engine": "windowed (auto)",
        "chunk_budget_MB": big.delta._chunk_budget >> 20,
        "setup_s": setup_s, "window_build_ms": window_s * 1e3,
        "warmup_steps": warm, "timed_steps": nsteps,
        "ms_per_step": elapsed / nsteps * 1e3, "f_iters": f_iters,
        "peak_memory_GiB": peak / 2**30, "held_before_GiB": held / 2**30,
        "profile_1_step": {"wall_ms": wall_ms, "device_ms": device_ms,
                           "device_busy_share": busy},
        "delta_engines": ab, "kernels": kernels}}))
    big.close()
    del big, st, X
    torch.cuda.empty_cache()

    # (c) probes and vorticity on the flagship
    probes = [{"type": "POINT", "field": "v", "path": "probe-v.txt",
               "loc": [1.5, 0.2], "n_monitor": 5},
              {"type": "VOLUME", "field": "p", "path": "probe-p.txt",
               "viewer": "ascii", "n_sum": 5,
               "box": {"x": [0.6, 1.2], "y": [-0.3, 0.3]}}]
    cfg = flagship_config(os.path.join(tmp, "probes"), nt=45)
    cfg["probes"] = probes
    flag = DecoupledIBPMSolver(cfg, device=DEVICE)
    _reset_counts()
    flag.run()
    box = flag.probes[1]
    slices = []
    for _ in range(5):  # the last n_sum steps, one at a time
        flag.nt += 1
        flag.run()
        slices.append(flag.state["p"][box._slices()].double().cpu().numpy())
    counts.append(_counts())
    hist = flag.stats_history
    _check_run(hist, 50, "vpf")
    _check_counts("flagship with probes", counts[-1],
                  {"K1": sum(2 + s["p_iters"] for s in hist)})
    flag.flush_logs()
    for probe in flag.probes:
        probe.close()
    v = flag.state["q"]["v"].double().cpu().numpy()
    mesh = flag.mesh
    xs, ys = mesh.coord(1, 0), mesh.coord(1, 1)
    i = int(np.searchsorted(xs, 1.5, side="right")) - 1
    j = int(np.searchsorted(ys, 0.2, side="right")) - 1
    wx = (1.5 - xs[i]) / (xs[i + 1] - xs[i])
    wy = (0.2 - ys[j]) / (ys[j + 1] - ys[j])
    want_v = ((1 - wy) * ((1 - wx) * v[j, i] + wx * v[j, i + 1])
              + wy * ((1 - wx) * v[j + 1, i] + wx * v[j + 1, i + 1]))
    lines = open(os.path.join(flag.output_dir, "probe-v.txt")).read().split()
    t_last, got_v = float(lines[-2]), float(lines[-1])
    rel_v = abs(got_v - want_v) / max(abs(want_v), 1e-30)
    text = open(os.path.join(flag.output_dir, "probe-p.txt")).read()
    block = text.rsplit("\nt = ", 1)[-1].split("\n")
    got_p = np.array([float(x) for x in block[2:] if x.strip()])
    want_p = np.mean(slices, axis=0).ravel()
    rel_p = float(np.abs(got_p - want_p).max() / np.abs(want_p).max())
    print(f"flagship probes after 50 steps: point v at (1.5, 0.2) t "
          f"{t_last:.6f}: {got_v:.8e} against numpy's bilinear "
          f"{want_v:.8e} (rel {rel_v:.3e}, tol 1e-6); volume p, "
          f"{got_p.size} values averaged over steps 46-50 against the box "
          f"slices' mean: rel {rel_p:.3e} (tol 1e-6); "
          f"{text.count(chr(10) + 't = ')} volume records, "
          f"{len(lines) // 2} point records")
    if not (rel_v <= 1e-6 and rel_p <= 1e-6 and abs(t_last - flag.t) < 1e-9
            and got_p.size == want_p.size):
        raise AssertionError("flagship probes differ from the fields")
    q64 = {k: a.double() for k, a in flag.state["q"].items()}
    card = compute_vorticity(mesh, flag.bc, q64, flag.bc.init_state(q64))
    q_cpu = {k: a.cpu() for k, a in q64.items()}
    cpu = compute_vorticity(mesh, flag.bc, q_cpu, flag.bc.init_state(q_cpu))
    rel_w = _rel_err(card["wz"].cpu(), cpu["wz"])
    print(f"flagship vorticity wz {tuple(card['wz'].shape)} float64, card "
          f"against CPU: rel {rel_w:.3e} (tol 1e-12)")
    if not rel_w <= 1e-12:
        raise AssertionError(f"vorticity differs on the card: {rel_w}")
    part("(c)")

    # (d) the stage profiler
    _chained_equals_step("flagship", flag)
    _profile_table("flagship", flag)
    _chained_equals_step("sphere (a)", sph)
    _profile_table("sphere (a)", sph)
    flag.close()
    sph.close()
    part("(d)")
    return counts


def _hold_at_shape(solver, applies: int) -> dict:
    """K1 (the pressure), K2a (u, v, w) and K3 at the solver's 3D shape
    against their twins bit for bit, float32, timed beside their bounds;
    returns their records."""
    import torch

    from petibm_tpu_torch.linalg.mg import poisson_level0
    from petibm_tpu_torch.operators import cuda_stencil as cs

    cuda = torch.device(DEVICE)
    gen = torch.Generator(device=cuda).manual_seed(13)
    mesh, bcs = solver.mesh, solver.bc
    label = f"refined sphere {tuple(mesh.shape(3))} float32"

    def randn(shape):
        return torch.randn(tuple(shape), generator=gen, device=cuda,
                           dtype=torch.float32)

    level = poisson_level0(mesh.dxp, mesh.periodic, dtype=torch.float32,
                           device=cuda, scale=solver.dt)
    out = {"K1": _hold_k1(f"K1 {label} p", level, randn(level.shape),
                          applies)}
    A = cs.make_cuda_momentum(mesh, bcs, solver.dt, 0.5 * solver.nu,
                              dtype=torch.float32, device=cuda)
    for c, comp in enumerate("uvw"):
        rec = _hold_k2(f"K2a {label} {comp}", randn(mesh.shape(c)),
                       A.vecs[comp], A.periodic, None, 1e-6, applies)
        out.setdefault("K2a", rec)
    out["K3"] = _hold_k3("K3 refined sphere", mesh, bcs,
                         {k: randn(mesh.shape(c))
                          for c, k in enumerate("uvw")}, applies)
    return out


def main() -> int:
    import tempfile

    t_start = time.perf_counter()

    def done(phase: int) -> None:
        print(f"phase {phase} done at {time.perf_counter() - t_start:.1f} s")

    device = phase0_device()
    phase1_build()
    done(1)
    with tempfile.TemporaryDirectory() as tmp:
        records = phase2_kernels(tmp)
        done(2)
        flagship, counts_2d = phase3_slice(tmp)
        phase4_ab(tmp, flagship)
        done(4)
        sphere, counts_sphere = phase5_sphere(tmp)
        tgv, counts_tgv = phase6_tgv(tmp)
        phase7_ab3d(tmp, sphere, tgv)
        done(7)
        mg_solvers, counts_mg = phase8_mg(tmp)
        done(8)
        phase9_mg_ab(tmp, *mg_solvers)
        done(9)
        counts_coupled = phase10_coupled(tmp)
        done(10)
        counts_moving = phase11_moving(tmp)
        done(11)
        counts_windowed = phase12_windowed(tmp)
        done(12)
    # each main path's launches, counted from 0 just before it ran
    runs = ([counts_2d, counts_sphere, counts_tgv] + counts_mg
            + counts_coupled + counts_moving + counts_windowed)
    launches = {key: sum(run[key] for run in runs) for key in counts_2d}
    source = "petibm_tpu_torch/csrc/"
    stencil = "petibm_tpu/operators/pallas_stencil.py:"
    table = [("K1", "poisson_apply_separable", "poisson_separable.cu",
              f"{stencil}117"),
             ("K2a", "zblocked_helmholtz_apply (momentum)",
              "zblocked_helmholtz.cu", f"{stencil}318"),
             ("K2b", "zblocked_helmholtz_apply (periodic Poisson)",
              "zblocked_helmholtz.cu", f"{stencil}388"),
             ("K3", "convection3d_apply", "convection3d.cu", f"{stencil}473"),
             ("K4/K5", "fused line sweep", "line_sweep.cu",
              "petibm_tpu/linalg/pallas_sweep.py:150,230"),
             ("K6/K7", "batched PCR", "tridiag_pcr.cu",
              "petibm_tpu/linalg/pallas_pcr.py:69,100")]
    print(json.dumps({"kernels": [dict(
        name=f"{key} {name}", route="cuda", source=source + src,
        replaces=replaces, launches=launches[key], **records[key])
        for key, name, src, replaces in table]}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
