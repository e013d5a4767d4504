"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order (any failure raises and the script exits non-zero):

0. require CUDA; print the torch/CUDA versions and the card's name and
   power limit;
1. build the hand-written kernels K1-K7 and the delta engine's E and H
   from ``petibm_tpu_torch/csrc`` (and ``graph_cond.cu``, phase 14's IF
   nodes), one nvcc per source, all at once, and print the registers and
   spills of the line kernels (K4/K5, K6/K7), of E and H, and of K1, K2
   and K3, instance by
   instance (``ptxas -v``); an instance of a march (K1's z march and
   row march, K2, K3) that spills fails the phase;
2. hold each kernel against its plain PyTorch twin on the card at the
   shapes of the main paths, and time both beside the kernel's bound
   (bytes moved once over 3.35 TB/s, or operations over the card's peak)
   (K1 and K2b both at the sphere's pressure shape, timed in turns;
   K1's 2D row march, its plan printed, in turns with its first design
   at 450^2 and 512^2 in float32 and float64 and at 450^2 in bfloat16,
   beside ``copy_`` of the field as the floor);
   time one PyTorch call computing K1's (at its shapes), K2a's
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
   non-periodic levels, K6/K7 on periodic ones): the flagship (10 warm-up
   and 10 timed steps), the sphere (10 steps) and the 256^3 TGV (10
   steps, the energy does not grow), each through ``run()`` with every
   launch count checked against the stats and its device busy share
   profiled over a few more steps (device ms per V-cycle beside the
   profile window's p_iters);
9. A/B the three MG-CG paths (1 step each, float64 and float32) with
   the kernels on and off from their developed states, and small MG-CG
   cases on the card against the CPU path;
10. run the coupled IBPM through ``IBPMSolver.run()``:
   ``examples/ibpm/cylinder2dRe550`` and its pinned-pressure twin
   ``cylinder2dRe550_GPU`` (450^2 stretched, 314 points, float32) for
   1200 steps to t = 3 each in chunks of 100 steps (``stepsPerDispatch``,
   phase 14's path), every solve converged, Cd(t) within rms 0.06
   and max 0.12 of the Koumoutsakos & Leonard (1995) curve over t in
   [0.5, 3], setup seconds (the Schur build) and ms/step printed, one
   JSON line each; Re=550 with ``fdm: false`` (CG on the coupled system,
   the V-cycle with K1 at its level-0 residual and the K4/K5 sweeps) for 2
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
   JAX package's phase names, both tables printed;
13. the FFT transforms and the bfloat16 V-cycle: (a) the 256^3 TGV with
   ``fdm: {velocity: false, fft: true}`` (its pressure solve by rfftn /
   irfftn on all three axes) for phase 6's 20 steps beside phase 6's
   dense-transform run: ms/step, busy shares, energies, the fields'
   difference at step 20, refinement passes, launches against the stats;
   (b) phase 8's MG cells with ``mg: {dtype: bfloat16}``: the TGV for 5
   steps through ``run()`` (converged, launches against the stats, p_iters
   and device ms per V-cycle beside float32), and one pressure system of
   the flagship and of the sphere by CG with the float32 and the bfloat16
   V-cycle (the bfloat16 one does not converge on their stretched grids:
   reported); (c) in float64, card against CPU: the pinned periodic TGV2D
   at 32^2 (its FDM solve by FFT), a 16^3 TGV with ``fdm.fft: true`` and
   the 32^2 cylinder with the bfloat16 V-cycle (its V-cycle inputs
   compared);
14. ``stepsPerDispatch``: seven cells from one start each, their steps in
   chunks of k (the step one CUDA graph, its loops capped copies of their
   bodies under CUDA IF nodes, replayed k times, one host read a chunk)
   beside the same steps one at a time: (a) the flagship, 100 steps, k
   50; (b) the sphere, 50, 25; (c) the 256^3 TGV, 20, 10; (d) the
   coupled Re=550, 100, 50; (e) the oscillating cylinder, 100, 50; (f)
   the flagship with ``fdm: false``, 10, 5; (g) (f) with its CG loop's
   cap forced to 4, 5, 5: it overflows, reruns and recaptures; (h) the
   coupled Re=550 with ``fdm: false``, one chunk of 2 for its graph's
   size; (i) the oscillating cylinder on the windowed delta engine (its
   window box the whole grid), 20, 10.  Each holds fields and stats at
   tolerance 0 and prints both
   runs' ms/step, the graph's nodes, capture and instantiate seconds,
   the caps, overflows and peak memory, beside the card's name and power
   limit; then profiles up to 10 single steps and one chunk (the
   device ms a step of each, the busy share, the IF nodes'
   ``set_conditional`` kernels) and runs one chunk captured with the
   launch counters on the card (``_kernels.count_on_device``): its
   launches held against the stats, the wrappers' host counters 0 over
   it (a replay does not enter them); one ``{"chunked": ...}`` JSON
   line.

15. the domain decomposition (``parameters.sharding``): two ranks on the
   one card, processes of this script (``--phase15-rank``), through the
   solver API, NCCL with a host id of its own per rank
   (``P15_NCCL_ENV``): the flagship on a [1, 2] mesh for 11 steps and
   on [2, 1] for 5, the sphere on [1, 2] for 5, the flagship with ``fdm:
   false`` (the decomposed V-cycle) for 3, the coupled Re=550 for 1, the
   oscillating cylinder for 5, the sphere on the 3-axis [2, 1, 1] mesh
   for 3 (the FDM's contraction core) and with ``fdm: false`` for 1 (K5
   on z pencils), the sphere with the windowed engine for 3 and the
   flagship with ``fdm.repartition: false`` and two probes for 10, each
   beside a single-rank card run from the same start (fields, forces
   and probe files within 1e-4 of their largest value, or the coupled
   cell's own one-ulp spread, v/p/f iterations equal on 95% of the
   steps); the 32^2 cylinder, its ``fdm: false``, coupled, moving,
   windowed-with-probes and windowed moving variants and the 24x20x16
   sphere on [2, 1, 1] (FDM and ``fdm: false``) in float64 beside a
   single-rank CPU run (1e-9, iterations and fallbacks equal); ms/step
   of each rank beside the single rank's, the FDM core, the halo
   exchanges, all-reduces, all-to-alls and reduce-scatters a step and
   their bytes; one
   ``{"distributed": ...}`` JSON line a cell.  On the ranks K1-K3 launch
   no time (the JAX package's gates under a mesh) and K4/K5 (K6/K7) as
   their V-cycles imply.  The flagship on [1, 2] and its ``fdm: false``
   also run their last 10 and 2 steps again in chunks of 5 and 2, each
   rank's step one CUDA graph with its collectives in it (the loops'
   copies masked: an IF node's body takes no NCCL collective), each
   rank's state bit-equal to its single steps, K4/K5 counted on the
   card inside the graphs.

16. E and H of the factor delta engine (``ibm/cuda_delta.py``) at the
   benchmark's sphere and cylinder shapes in float32 and float64: each
   kernel bit-equal to its plain twin on the card (H as the step's u + dt
   H f, twice bit-equal), timed beside its bound (the window cells once),
   its twin and the dense factor-row matmuls it replaced
   (``library_ms``); one ``{"delta": ...}`` JSON line.  Alone:
   ``python -c "import chip_smoke, tempfile;
   chip_smoke.phase16_delta(tempfile.mkdtemp())"``.

A kernel wrapper counts a launch where it launches its kernel: on the
host outside a CUDA graph's capture, and on the card too while
``count_on_device`` is on, which a graph captures beside the kernel
(``_kernels.count_launch``).  The ``launches`` of the per-kernel JSON
record sum the host counts over every main path and the card's counts
over phase 14's counted chunks.

Phase 2 holds K1 (450^2, the oscillating cylinder's 512^2 and the
sphere's pressure), K2a and K2b (every
shape), K3 (the sphere's and the TGV's three components from one
launch), K4/K5 (levels 0 and 1 of the flagship and of the sphere, every
line direction; and at the decomposed flagship's level-0 pencil and
block on [1, 2], on each rank's factors) and K6/K7 (the TGV's 256^3,
128^3 and 64^3 levels, every
axis) against their twins bit for bit, and the bfloat16 instances (K1
at 450^2 and the sphere's pressure, K4/K5 at both level 0s, K6/K7 at
256^3) too, times K1's 3D march and K2 beside
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
#: the hand kernels' sources, and the IF-node helper of the chunked step
#: and the delta engine's E and H (csrc/graph_cond.cu, csrc/delta_ops.cu:
#: no TPU kernel's port)
KERNEL_SOURCES = ("poisson_separable", "zblocked_helmholtz", "convection3d",
                  "line_sweep", "tridiag_pcr", "graph_cond", "delta_ops")
#: the sources of a march and the names of its kernels (csrc/march.cuh's
#: zmarch, K1's 2D rowmarch; K3's own), none of whose instances may spill
MARCH_SOURCES = {"poisson_separable": ("zmarch", "rowmarch"),
                 "zblocked_helmholtz": ("zmarch",),
                 "convection3d": ("convection3d_march",)}
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


#: seconds the timed batches of one ``_time_ms`` call may take
TIME_BUDGET_S = 1.0


def _time_ms(fn, arg, applies: int = 200, batch: int = 20,
             warm: int = 10) -> tuple:
    """Median times of one ``fn(arg)`` over ``applies`` calls, in batches
    of ``batch`` after ``warm`` warm-up calls: (device ms, host ms).  A
    function whose
    warm-up calls take more than ``TIME_BUDGET_S`` over all the batches
    (a twin of a few ms and more) gets fewer batches, at least 2.

    Device: CUDA events around a batch that the host enqueued while the
    card was held busy by a spin kernel, so the batch runs back to back
    and launch overhead on the host is not in the number.  Host: wall
    clock per call of a synchronised batch, which is what a caller that
    enqueues one call at a time waits."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warm):
        fn(arg)
    torch.cuda.synchronize()
    per_call = (time.perf_counter() - t0) / warm
    batches = max(2, min(applies // batch,
                         int(TIME_BUDGET_S / (2 * batch * per_call))))
    device, host = [], []
    for _ in range(batches):
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


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def phase0_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    smi = _smi()
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
    try:
        import yaml  # noqa: F401

        has_yaml = "yes"
    except ImportError:
        has_yaml = "no"
    # every phase passes dicts (phase 15's ranks read theirs as JSON)
    print(f"pyyaml imports: {has_yaml} (configs go as dicts either way)")
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
    for source in ("line_sweep", "tridiag_pcr", "delta_ops", *MARCH_SOURCES):
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
                if (any(k in name for k in MARCH_SOURCES.get(source, ()))
                        and "spill" in line
                        and " 0 bytes spill stores, 0 bytes spill loads"
                        not in line):
                    spills.append(name)
    if spills:
        raise AssertionError(f"march instances spill: {spills}")


def _mesh_and_bcs(cfg: dict):
    from petibm_tpu_torch.boundary import BoundarySet
    from petibm_tpu_torch.mesh import StaggeredMesh

    mesh = StaggeredMesh(cfg)
    return mesh, BoundarySet(mesh, cfg)


def _rel_err(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


#: H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, and operations/s
#: outside the tensor cores in float32 and float64; bfloat16 at the
#: tensor cores' dense rate, the table's only bfloat16 rate (every bfloat16
#: kernel here binds by bytes, far above either rate's time)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12}


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
    # the twins take 0.05-20 ms a call: a quarter of the applies, in
    # batches of 5 after 3 warm-up calls, times them well inside their
    # spread (each batch waits behind a ~25 ms spin kernel)
    plain_ms, plain_host_ms = _time_ms(twin, arg, max(applies // 4, 10),
                                       batch=5, warm=3)
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


def _library(label: str, rec: dict, csr, arg, want, applies: int,
             tol: float = 1e-5) -> None:
    """One PyTorch call computing the kernel's function, timed on ``arg``
    beside the kernel (``rec``): ``torch.sparse.mm`` with the operator
    assembled once as CSR.  Its result is held to the kernel's ``want``
    at ``tol`` relative (another order of summation: 1e-5 in float32;
    bfloat16 sums rounded in another order, and the operator's entries
    rounded as products, take a few units of 2^-8 of the largest
    value)."""
    import torch

    col = arg.reshape(-1, 1)
    rel = _rel_err(torch.sparse.mm(csr, col).reshape(arg.shape).float(),
                   want.float())
    rec["library_ms"] = _time_ms(lambda v: torch.sparse.mm(csr, v), col,
                                 applies)[0]
    print(f"{label} library torch.sparse.mm (CSR, {csr.values().numel()} "
          f"values): {rec['library_ms'] * 1e3:.2f} us per apply (device), "
          f"kernel {rec['ms'] * 1e3:.2f} us; rel diff {rel:.3e} (tol {tol:g})")
    if not rel <= tol:
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
        applies = 60 if dtype == torch.float32 else 24
        tol = tols[dtype]
        # K1: the flagship's, the oscillating cylinder's and the sphere's
        # pressure, bit for bit; the 2D row march also beside its first
        # design and the copy_ floor
        for name in ("450x450", "oscillating", "sphere"):
            mesh = meshes[name][0]
            level = poisson_level0(mesh.dxp, mesh.periodic, dtype=dtype,
                                   device=cuda,
                                   scale=cases[name]["parameters"]["dt"])
            phi = randn(level.shape, dtype)
            label = f"K1 {name} p {tuple(level.shape)} {tag}"
            rec = _hold_k1(label, level, phi, applies)
            if dtype == torch.float32 or name == "450x450":
                _library(f"K1 {name} p {tag}", rec, _k1_csr(level), phi,
                         cs.poisson_apply_separable(phi, level), applies)
            if (name, dtype) == ("sphere", torch.float32):
                records["K1"] = rec
            if name != "sphere":
                _k1_beside_2d(label, phi, level, rec, applies)
            if (name, dtype) == ("450x450", torch.float32):
                k1_2d = rec
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
        for name, shape in (("450x450", [1, 2]), ("sphere", [2, 1, 1])):
            _hold_pencils(name, meshes[name][0], shape,
                          cases[name]["parameters"]["dt"], dtype, randn,
                          applies // 2)
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
    # K1's 2D row march (the main path's K1) at 450^2 in float32
    records["K1"]["2d"] = {k: k1_2d[k] for k in _BF16_KEYS + _BESIDE_KEYS}
    _phase2_bf16(records, cases, meshes, randn)
    return records


def _hold_pencils(name: str, mesh, shape: list, dt: float, dtype, randn,
                  applies: int) -> None:
    """K4/K5 at the shapes of a decomposed level 0 (phase 15's MG cells:
    the flagship on [1, 2], the sphere on [2, 1, 1]), on each rank's
    factors: a sweep along a cut direction on its pencil of whole lines
    (the flagship's 225 x 450 x lines, the sphere's 130 x 65 x 160 z
    lines), the others on its block, the couplings of the folded
    directions zero in the operands (``PoissonMG.sweep_layout``), bit for
    bit with the twin.  The ranks' layout comes from a process mesh
    without a group (``ProcessMesh(shape, rank=...)``)."""
    import torch

    from petibm_tpu_torch.linalg import cuda_sweep
    from petibm_tpu_torch.linalg.mg import PoissonMG
    from petibm_tpu_torch.parallel import Partition, ProcessMesh

    size = torch.finfo(dtype).bits // 8
    for rank in range(math.prod(shape)):
        mg = PoissonMG(mesh.dxp, mesh.periodic, dtype=dtype,
                       device=DEVICE, scale=dt)
        mg.set_mesh(Partition(mesh, ProcessMesh(shape, rank=rank)))
        for d in range(mesh.dim):
            level, fold = mg.sweep_layout(0, d)
            aux = mg.folded_aux(level, d, fold)
            lshape = tuple(level.shape)
            axis = mesh.dim - 1 - d
            pair = (randn(lshape, dtype), randn(lshape, dtype))
            n = pair[0].numel()
            pad = 3 - mesh.dim
            plan = cuda_sweep.launch_plan((1,) * pad + lshape, axis + pad)
            where = "pencil" if mg.blocks[0].cut(d) else "block"
            ops = 7 + 6 * (mesh.dim - 1) + 14 * _steps(lshape[axis])
            _hold(f"K4/K5 {name} {shape} rank {rank} level 0 {where} "
                  f"{lshape} direction {d} {plan} {str(dtype)[6:]}",
                  lambda a: cuda_sweep.fused_sweep(a[0], a[1], aux, axis,
                                                   1.0),
                  lambda a: cuda_sweep.fused_sweep_ref(a[0], a[1], aux, axis,
                                                       1.0),
                  pair, 0.0, applies,
                  ((3 * n + sum(t.numel() for t in aux)) * size, ops * n,
                   dtype))


#: the record keys of a bfloat16 hold in the JSON line
_BF16_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")


def _phase2_bf16(records: dict, cases: dict, meshes: dict, randn) -> None:
    """The bfloat16 instances (the mixed-precision V-cycle's hierarchy)
    against their twins at tolerance 0, timed beside their bounds (2-byte
    values read and written once): K1 at 450^2 and the sphere's pressure
    (beside ``torch.sparse.mm`` on the bfloat16 CSR operator where
    cuSPARSE takes it), K4/K5 at the flagship's and the sphere's level 0,
    every direction, K6/K7 at 256^3, every axis.  Each kernel's record
    takes its main shape's hold as ``bf16``."""
    import torch

    from petibm_tpu_torch.linalg import cuda_pcr, cuda_sweep
    from petibm_tpu_torch.linalg.mg import PoissonMG, poisson_level0
    from petibm_tpu_torch.operators import cuda_stencil as cs

    cuda, bf16, applies = torch.device(DEVICE), torch.bfloat16, 40

    def keep(key, rec):
        records[key]["bf16"] = {k: rec[k] for k in _BF16_KEYS}

    for name in ("450x450", "sphere"):
        mesh = meshes[name][0]
        level = poisson_level0(mesh.dxp, mesh.periodic, dtype=bf16,
                               device=cuda,
                               scale=cases[name]["parameters"]["dt"])
        phi = randn(level.shape, bf16)
        label = f"K1 {name} p {tuple(level.shape)} bfloat16"
        rec = _hold_k1(label, level, phi, applies)
        try:
            csr = _k1_csr(level)
            torch.sparse.mm(csr, phi.reshape(-1, 1))
            torch.cuda.synchronize()
        except RuntimeError as err:
            print(f"{label}: torch.sparse.mm does not take the bfloat16 CSR "
                  f"operator on this card ({str(err).splitlines()[0]}); "
                  "no library time")
        else:
            _library(label, rec, csr, phi,
                     cs.poisson_apply_separable(phi, level), applies,
                     tol=2.0 ** -5)
        if name == "sphere":
            keep("K1", rec)
        else:
            _k1_beside_2d(label, phi, level, rec, applies)
    for name in ("450x450", "sphere"):
        mesh = meshes[name][0]
        mg = PoissonMG(mesh.dxp, mesh.periodic, dtype=bf16, device=cuda,
                       scale=cases[name]["parameters"]["dt"])
        shape = tuple(mg.levels[0].shape)
        pair = (randn(shape, bf16), randn(shape, bf16))
        n = pair[0].numel()
        shape3 = (1,) * (3 - mesh.dim) + shape
        for d in range(mesh.dim):
            axis, aux = mesh.dim - 1 - d, mg._aux(0, d)
            plan = cuda_sweep.launch_plan(shape3, axis + 3 - mesh.dim)
            ops = 7 + 6 * (mesh.dim - 1) + 14 * _steps(shape[axis])
            rec = _hold(
                f"K4/K5 {name} level 0 {shape} direction {d} bfloat16 "
                f"{plan}",
                lambda a: cuda_sweep.fused_sweep(a[0], a[1], aux, axis, 1.0),
                lambda a: cuda_sweep.fused_sweep_ref(a[0], a[1], aux, axis,
                                                     1.0),
                pair, 0.0, applies,
                ((3 * n + sum(t.numel() for t in aux)) * 2, ops * n, bf16))
            if (name, d) == ("sphere", 0):
                keep("K4/K5", rec)
        del mg, pair
    mesh = meshes["tgv256"][0]
    mg = PoissonMG(mesh.dxp, mesh.periodic, dtype=bf16, device=cuda,
                   scale=cases["tgv256"]["parameters"]["dt"])
    shape = tuple(mg.levels[0].shape)
    rhs = randn(shape, bf16)
    n = rhs.numel()
    for d in range(3):
        axis = 2 - d
        dl, diag, du = mg._line_system(0, d)
        rec = _hold(
            f"K6/K7 tgv256 level 0 {shape} axis {axis} "
            f"{cuda_pcr.launch_plan(shape, axis)} bfloat16",
            lambda x: cuda_pcr.pcr(dl, diag, du, x, axis),
            lambda x: cuda_pcr.pcr_ref(dl, diag, du, x, axis), rhs, 0.0,
            applies, (5 * n * 2, (14 * _steps(shape[axis]) + 1) * n, bf16))
        if axis == 0:
            keep("K6/K7", rec)


def _hold_k1(label: str, level, phi, applies: int) -> dict:
    """K1 against its twin bit for bit on ``phi``, timed beside its bound
    (the field read and written once, and the 1D factors)."""
    from petibm_tpu_torch.operators import cuda_stencil as cs

    n = phi.numel()
    small = sum(t.numel() for t in level.c1d + level.w1d)
    plan = f" plan {tuple(cs.separable_plan_on_card(phi))}"
    return _hold(f"{label}{plan}",
                 lambda x: cs.poisson_apply_separable(x, level),
                 lambda x: cs.poisson_apply_separable_ref(x, level),
                 phi, 0.0, applies,
                 ((2 * n + small) * phi.element_size(),
                  (26 if phi.ndim == 3 else 15) * n, phi.dtype))


#: the keys ``_k1_beside_2d`` adds to a record: the first design's and
#: the copy_ floor's median ms per apply
_BESIDE_KEYS = ("cells_ms", "copy_ms")


def _k1_beside_2d(label: str, phi, level, rec: dict, applies: int) -> None:
    """K1's 2D row march beside its first design (one thread per cell),
    equal to the twin bit for bit, timed in turns (march, cells, cells,
    march), and beside one floor: ``copy_`` of the field into another,
    timed the same way, which moves the bytes of the bound (the field
    read once, the output written once).  Adds the medians to ``rec``
    (``_BESIDE_KEYS``)."""
    import torch

    from petibm_tpu_torch.operators import cuda_stencil as cs

    if not torch.equal(cs.separable_launch_cells(phi, level),
                       cs.poisson_apply_separable_ref(phi, level)):
        raise AssertionError(f"{label}: the cell kernel differs from the "
                             "twin")
    out = torch.empty_like(phi)

    def march(x):
        return cs.poisson_apply_separable(x, level)

    def cells(x):
        return cs.separable_launch_cells(x, level)

    times = [_time_ms(g, phi, applies)[0] for g in (march, cells, cells,
                                                    march)]
    copy_ms = _time_ms(lambda x: out.copy_(x), phi, applies)[0]
    rec.update(cells_ms=statistics.median(times[1:3]), copy_ms=copy_ms)
    print(f"{label}: row march {times[0] * 1e3:.2f}, {times[3] * 1e3:.2f} "
          f"us; cell kernel {times[1] * 1e3:.2f}, {times[2] * 1e3:.2f} us; "
          f"floor copy_ {copy_ms * 1e3:.2f} us (device, median per apply); "
          f"bound {rec['bound_ms'] * 1e3:.2f} us; row march / copy_ "
          f"{statistics.median((times[0], times[3])) / copy_ms:.3f}")


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
    from petibm_tpu_torch import _kernels

    _kernels.reset_launch_counts()


def _by_kernel(n: dict) -> dict:
    """The wrappers' counters as K1, K2a (unscaled K2), K2b (scaled K2),
    K3, K4/K5 and K6/K7."""
    return {"K1": n["K1"], "K2a": n["K2"] - n["K2 scaled"],
            "K2b": n["K2 scaled"], "K3": n["K3"], "K4/K5": n["K4/K5"],
            "K6/K7": n["K6/K7"]}


def _counts() -> dict:
    """Launches since the last reset (``_by_kernel``)."""
    import torch

    from petibm_tpu_torch import _kernels

    torch.cuda.synchronize()
    return _by_kernel(_kernels.launch_counts())


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
    # phase 13 (a) prints the FFT run beside this one
    solver.smoke_report = {"ms_step": elapsed / 19 * 1e3,
                           "energies": energies}
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
    _ab("sphere", make_sphere, state_to_numpy(sphere.state), 5, _ibm_fields,
        f32_tol=1e-4)
    _ab("tgv256", make_tgv, state_to_numpy(tgv.state), 3,
        lambda s: dict(s.state["q"], p=s.state["p"]), f32_tol=1e-4)

    def small(dev, tag):
        s = NavierStokesSolver(tgv3d_config(os.path.join(tmp, f"tgv16_{tag}"),
                                            n=16, nt=10, dt=0.05,
                                            dtype="float64"), device=dev)
        tgv3d_initial_state(s)
        return s

    _cuda_vs_cpu("tgv 16^3", small, ("p",))


def _profile(solver, steps: int) -> dict:
    """``steps`` more steps through ``run()`` under torch.profiler: the
    wall and device ms a step and the busy share (only the device-side
    events count: the operators that launch them carry the same time
    again), the kernels a step and the device ms a step of the IF nodes'
    ``set_conditional`` kernels.  The profiler's raw events are read:
    ``key_averages()`` takes about a millisecond an event to build, a
    minute for one step of a Krylov force solve."""
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
    busy_ns = cond_ns = kernels = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        busy_ns += e.duration_ns()
        if name.startswith(("Memcpy", "Memset")):
            continue
        kernels += 1
        if "set_conditional" in name:
            cond_ns += e.duration_ns()
    return {"busy": busy_ns / 1e3 / wall_us,
            "wall_ms_step": wall_us / steps / 1e3,
            "device_ms_step": busy_ns / steps / 1e6,
            "set_conditional_ms_step": cond_ns / steps / 1e6,
            "kernels_step": kernels / steps}


def _busy_share(solver, steps: int = 5) -> tuple:
    """Device busy share over ``steps`` more steps, with the wall and
    device ms per step (``_profile``)."""
    p = _profile(solver, steps)
    return p["busy"], p["wall_ms_step"], p["device_ms_step"]


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
               extra: str = "", profile_steps: int = 3) -> None:
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
    # phase 13 prints its bfloat16 cells beside these
    solver.smoke_report = {"ms_step": elapsed / nsteps * 1e3,
                           "p_iters": p_iters, "busy": busy,
                           "device_ms_vcycle": device_ms / vcycles}


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
    """The three cells with ``fdm: false`` through run(): the flagship (10
    warm-up + 10 timed steps), the sphere (5 + 5), the 256^3 TGV (10 in
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
    elapsed = _timed_run(flag, 10, 20)
    counts.append(_counts())
    _check_run(flag.stats_history, 20, "vpf")
    _check_counts("flagship mg", counts[-1], _mg_counts(flag))
    st = flag.state
    _check_fields({"p": st["p"], "f": st["f"]},
                  {"p": flag.mesh.shape(3), "f": (flag.bodies.n_pts, 2)})
    fx, fy = flag.bodies.avg_forces(st["f"].cpu().numpy())[0]
    _report_mg("flagship mg", flag, elapsed, 10,
               f"; t = {flag.t:.4f}: Cd {2 * fx:.5f}, Cl {2 * fy:.5f}")

    # the sphere: 3D K4/K5, K1, BiCGStab on K2a, K3
    sph = DecoupledIBPMSolver(sphere_config(os.path.join(tmp, "mg_sphere"),
                                            fdm=False), device=DEVICE)
    _reset_counts()
    elapsed = _timed_run(sph, 5, 10)
    counts.append(_counts())
    _check_run(sph.stats_history, 10, "vpf")
    hist = sph.stats_history
    _check_counts("sphere mg", counts[-1], dict(
        _mg_counts(sph), K2a=sum(3 * (1 + 2 * s["v_iters"]) for s in hist),
        K3=len(hist)))
    st = sph.state
    _check_fields(dict(st["q"], p=st["p"]),
                  {k: sph.mesh.shape(f) for f, k in enumerate("uvwp")})
    fx, fy, fz = sph.bodies.avg_forces(st["f"].cpu().numpy())[0]
    _report_mg("sphere mg", sph, elapsed, 5,
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
    tgv.smoke_report["energies"] = energies
    for solver in (flag, sph, tgv):
        solver.close()
    return (flag, sph, tgv), counts


def phase9_mg_ab(tmp: str, flag, sph, tgv) -> None:
    """The MG-CG paths with the kernels on and off from their developed
    states, one step each (float64 to 1e-10 with equal iteration counts,
    float32 to 1e-4), then small MG-CG cases on the card against the CPU
    path."""
    from petibm_tpu_torch.convert import state_to_numpy
    from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver
    from petibm_tpu_torch.solvers.navierstokes import NavierStokesSolver

    def make(config, cls):
        def make_solver(name, **params):
            return cls(config(os.path.join(tmp, name), fdm=False, **params),
                       device=DEVICE)
        return make_solver

    # one step each: the stencil side runs the smoother's plain twins,
    # ~3 s a step on the sphere
    tols = dict(f32_tol=1e-4, f64_tol=1e-10, same_iters=True)
    _ab("450x450 mg", make(flagship_config, DecoupledIBPMSolver),
        state_to_numpy(flag.state), 1, _ibm_fields, **tols)
    _ab("sphere mg", make(sphere_config, DecoupledIBPMSolver),
        state_to_numpy(sph.state), 1, _ibm_fields, **tols)
    _ab("tgv256 mg", make(tgv3d_config, NavierStokesSolver),
        state_to_numpy(tgv.state), 1,
        lambda s: dict(s.state["q"], p=s.state["p"]), **tols)
    _cuda_vs_cpu("32^2 mg", lambda dev, tag: DecoupledIBPMSolver(small_config(
        os.path.join(tmp, f"small_mg_{tag}"), nt=10, dtype="float64",
        fdm=False), device=dev), ("p", "f"))

    def small_tgv(dev, tag):
        s = NavierStokesSolver(tgv3d_config(
            os.path.join(tmp, f"tgv16_mg_{tag}"), n=16, nt=5, dt=0.05,
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
    ``IBPMSolver.run()`` in chunks of 100 steps: steps 1 to ``warm``, then
    on to 1200 (t = 3) timed; every solve converged; Cd(t) from the forces log against K&L.
    Returns (the open solver, its record, the launches of the run)."""
    import numpy as np
    import torch

    from petibm_tpu_torch.solvers.ibpm import IBPMSolver

    t0 = time.perf_counter()
    solver = IBPMSolver(re550_config(out, pinned, stepsPerDispatch=100),
                        device=DEVICE)
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
              "steps_per_dispatch": solver.steps_per_dispatch,
              "chunk_overflows": solver.chunk_overflows,
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
        # the wrappers count the launches outside the graph (the chunks'
        # warm-up step); phase 14 (d) counts a chunk's kernel events
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
    elapsed = _timed_run(mg, 1, 2)
    counts.append(_counts())
    _check_run(mg.stats_history, 2, "vp")
    _check_counts("re550 mg", counts[-1], _mg_counts(mg, 1))
    _report_mg("re550 mg", mg, elapsed, 1, profile_steps=1)
    mg.close()
    part("re550 mg")
    # its stencil side runs the smoother's twins, ~20 s a step in each
    # dtype
    _ab("re550 mg", make_mg, state_to_numpy(mg.state), 1, _ibm_fields,
        f32_tol=1e-4, f64_tol=1e-10, same_iters=True)
    part("re550 mg A/B")

    # (d) small cases, card against CPU
    _reset_counts()
    _cuda_vs_cpu("32^2 coupled", lambda dev, tag: IBPMSolver(small_config(
        os.path.join(tmp, f"small_ibpm_{tag}"), nt=10, dtype="float64"),
        device=dev), ("p", "f"))
    _check_counts("32^2 coupled", _counts(), {})
    _reset_counts()
    runs = _cuda_vs_cpu("24x20x16 coupled", lambda dev, tag: IBPMSolver(
        small3d_config(os.path.join(tmp, f"small3d_ibpm_{tag}"), nt=3,
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


def tgv2d_config(tmp: str, n: int = 32, **params) -> dict:
    """examples/navierstokes/taylorgreenvortex2dRe100 as a dict (the card
    need not have pyyaml), cut from 256^2 to n^2 cells: Re=100 (nu 0.01)
    on the periodic box [-pi, pi]^2, dt 0.01, BiCGStab + Jacobi velocity
    solve, CG + MG pressure solve, both at atol 1e-6, the symbolic
    initial fields."""
    pi = math.pi
    return _base(tmp, [{"direction": d, "start": -pi, "subDomains": [
        {"end": pi, "cells": n, "stretchRatio": 1.0}]} for d in "xy"],
        {"nu": 0.01,
         "initialVelocity": ["cos(x) * sin(y)", "- sin(x) * cos(y)"],
         "initialPressure": "- (cos(2*x) + cos(2*y)) / 4",
         "boundaryConditions": [
             {"location": d + side, "u": ["PERIODIC", 0.0],
              "v": ["PERIODIC", 0.0]}
             for d in "xy" for side in ("Minus", "Plus")]},
        **dict({"dt": 0.01,
                "velocitySolver": _solver_opts(1000, rtol=0.0,
                                               kspType="bicgstab",
                                               pc="jacobi"),
                "poissonSolver": _solver_opts(20000, rtol=0.0, pc="mg")},
               **params))


def _phase13_fft_tgv(tmp: str, dense) -> dict:
    """(a) The 256^3 TGV with ``fdm: {velocity: false, fft: true}`` (the
    pressure solve by rfft/irfft on all three axes) for phase 6's 20
    steps, beside phase 6's dense-transform run ``dense``: ms/step, the
    busy share of 5 more steps of each (the dense one from its step-20
    state), the energies, the fields' difference at step 20 and the
    refinement passes.  Returns the run's launches."""
    import torch

    from petibm_tpu_torch.convert import state_from_numpy, state_to_numpy
    from petibm_tpu_torch.solvers.navierstokes import NavierStokesSolver

    fdm = {"velocity": False, "fft": True}
    t0 = time.perf_counter()
    fft = NavierStokesSolver(tgv3d_config(os.path.join(tmp, "tgv_fft"), nt=1,
                                          fdm=fdm), device=DEVICE)
    tgv3d_initial_state(fft)
    if fft.poisson_fdm._fft_axes != (0, 1, 2):
        raise AssertionError(f"fft axes {fft.poisson_fdm._fft_axes}")
    torch.cuda.synchronize()
    print(f"tgv256 fft setup {time.perf_counter() - t0:.2f} s")
    energies = [_energy(fft.state["q"])]
    _reset_counts()
    fft.run()
    energies.append(_energy(fft.state["q"]))
    elapsed = 0.0
    for nt in (5, 10, 15, 20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fft.nt = nt
        fft.run()
        torch.cuda.synchronize()
        elapsed += time.perf_counter() - t0
        energies.append(_energy(fft.state["q"]))
    launches = _counts()
    hist = fft.stats_history
    _check_run(hist, 20, "vp")
    _check_counts("tgv256 fft", launches, {
        "K2a": sum(3 * (1 + 2 * s["v_iters"]) for s in hist),
        "K2b": sum(2 + s["p_iters"] for s in hist), "K3": len(hist)})
    n = fft.mesh.shape(0)
    _check_fields(dict(fft.state["q"], p=fft.state["p"]),
                  {"u": n, "v": n, "w": n, "p": n})
    print("tgv256 fft kinetic energy after steps 0, 1, 5, 10, 15, 20: "
          + ", ".join(f"{e:.8f}" for e in energies) + "; dense (phase 6): "
          + ", ".join(f"{e:.8f}" for e in dense.smoke_report["energies"]))
    if any(b > a for a, b in zip(energies, energies[1:])):
        raise AssertionError(f"kinetic energy grew: {energies}")
    diffs = {k: _rel_err(fft.state["q"][k], dense.state["q"][k])
             for k in "uvw"}
    diffs["p"] = _rel_err(fft.state["p"], dense.state["p"])
    print("tgv256 fft vs dense at step 20, max rel diff: " + ", ".join(
        f"{k} {v:.3e}" for k, v in diffs.items()))
    p_fft = [s["p_iters"] for s in hist]
    p_dense = [s["p_iters"] for s in dense.stats_history]
    print(f"tgv256 p_iters (refinement passes) fft {p_fft}, dense {p_dense}"
          + ("" if p_fft == p_dense else "; they differ at steps "
             + str([i + 1 for i, (a, b) in enumerate(zip(p_fft, p_dense))
                    if a != b])))
    # the busy share of 5 more steps of each, the dense run resumed from
    # its step-20 state in a solver of its own (phase 6's is closed)
    resumed = NavierStokesSolver(tgv3d_config(os.path.join(tmp, "tgv_dense"),
                                              nt=0), device=DEVICE)
    resumed.state = state_from_numpy(state_to_numpy(dense.state), DEVICE,
                                     resumed.dtype)
    busy = {"dense": _busy_share(resumed), "fft": _busy_share(fft)}
    for solver in (resumed, fft):
        _check_run(solver.stats_history, solver.nt, "vp")
        solver.close()
    print(f"tgv256 fft {elapsed / 19 * 1e3:.3f} ms/step over steps 2-20 "
          f"(synchronised), dense (phase 6) "
          f"{dense.smoke_report['ms_step']:.3f}; 5 more steps profiled: "
          + "; ".join(f"{k} {b[1]:.3f} ms/step wall, {b[2]:.3f} device, "
                      f"busy {b[0]:.4f}" for k, b in busy.items()))
    return launches


def _beside_f32(label: str, bf16, f32) -> None:
    """p_iters and device ms per V-cycle of the bfloat16 run beside the
    float32 run's (phase 8) over the same steps from the same start."""
    ours, theirs = bf16.smoke_report, f32.smoke_report
    n = len(ours["p_iters"])
    print(f"{label}: p_iters over steps 1-{n} bfloat16 {ours['p_iters']}, "
          f"float32 {theirs['p_iters'][:n]} (means "
          f"{statistics.mean(ours['p_iters']):.2f} / "
          f"{statistics.mean(theirs['p_iters'][:n]):.2f}); device ms per "
          f"V-cycle {ours['device_ms_vcycle']:.3f} / "
          f"{theirs['device_ms_vcycle']:.3f}; busy {ours['busy']:.4f} / "
          f"{theirs['busy']:.4f}")


def _bf16_system(label: str, solver, maxiter: int = 150) -> list:
    """One pressure system of ``solver`` (a consistent random right side,
    seeded) by CG with the float32 V-cycle and with the bfloat16 one
    (``solver``'s own preconditioner), at the cell's atol relative to the
    right side, at most ``maxiter`` iterations each: one bfloat16 V-cycle's
    output against the float32 one's, the iterations and the residual each
    reaches.  The float32 solve must converge; the bfloat16 one is
    reported.  Launches of each solve against its iterations (one V-cycle
    an application of M, the first residual's included; K1 as the CG
    operator and, in the bfloat16 V-cycle, at its level-0 residual).
    Returns the launches of the bfloat16 solve."""
    import torch

    from petibm_tpu_torch.linalg.krylov import cg

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    b = torch.randn(solver.poisson_mg.levels[0].shape, generator=gen,
                    device=DEVICE)
    b = b - b.mean()
    m32 = solver.poisson_mg.preconditioner()
    m16 = solver._M_p  # the solver's own: the bfloat16 V-cycle
    o32, o16 = m32(b), m16(b)
    print(f"{label}: one bfloat16 V-cycle against the float32 one: rel "
          f"diff {_rel_err(o16, o32):.3e} ({len(solver.poisson_mg_lp.levels)}"
          " levels)")
    sweeps = solver.poisson_mg.sweeps_per_vcycle()
    counts = None
    for tag, M in (("float32", m32), ("bfloat16", m16)):
        _reset_counts()
        res = cg(solver._negA_p, b, torch.zeros_like(b), M=M,
                 atol=1e-6 * float(b.norm()), maxiter=maxiter)
        counts = _counts()
        vcycles = 1 + res.iters
        _check_counts(f"{label} {tag} system", counts, {
            "K4/K5": sweeps * vcycles,
            "K1": 2 * vcycles})
        print(f"{label} {tag} V-cycle CG: converged {res.converged}, "
              f"{res.iters} iterations, residual {res.residual:.3e} (atol "
              f"{1e-6 * float(b.norm()):.3e})")
        if tag == "float32" and not res.converged:
            raise AssertionError(f"{label}: the float32 V-cycle CG did not "
                                 "converge")
    return [counts]


def _phase13_bf16_cells(tmp: str, flag32, sph32, tgv32) -> list:
    """(b) Phase 8's MG cells with ``mg: {dtype: bfloat16}`` (CG in
    float32, the V-cycle in bfloat16: K4/K5 or K6/K7 in bfloat16, K1 at
    its level-0 residual on the walled grids).  The 256^3 TGV through
    run() for 5 steps: every solve converged, every launch against the
    stats, p_iters and device ms per V-cycle beside the float32
    V-cycle's.  The flagship and the sphere: one pressure system each
    (``_bf16_system``).  Their stretched grids defeat the bfloat16
    V-cycle of the JAX package's design, which rounds the fields to
    bfloat16 between operations: a residual of a smooth field is a small
    difference of large terms there, and one V-cycle comes out far from
    the float32 one (printed), so their CG does not converge
    (``scripts/bf16_vcycle_error.py`` takes it apart on the CPU).  Returns
    the runs' launches."""
    import torch

    from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver
    from petibm_tpu_torch.solvers.navierstokes import NavierStokesSolver

    mg = {"dtype": "bfloat16"}

    def check_lp(solver, k1: bool) -> None:
        lp = solver.poisson_mg_lp
        if (lp.dtype != torch.bfloat16 or solver.poisson_mg.dtype
                != torch.float32 or (lp._fused_apply0 is not None) != k1):
            raise AssertionError("the bfloat16 V-cycle is not the one built")

    tgv = NavierStokesSolver(tgv3d_config(os.path.join(tmp, "bf16_tgv"),
                                          fdm=False, mg=mg), device=DEVICE)
    tgv3d_initial_state(tgv)
    check_lp(tgv, False)
    energies = [_energy(tgv.state["q"])]
    _reset_counts()
    elapsed = _timed_run(tgv, 1, 5)
    energies.append(_energy(tgv.state["q"]))
    counts = [_counts()]
    hist = tgv.stats_history
    _check_run(hist, 5, "vp")
    # K2b is the CG operator alone: the bfloat16 V-cycle's periodic
    # level-0 residual is its closure, as in the JAX package
    _check_counts("tgv256 mg bf16", counts[-1], dict(
        _mg_counts(tgv, level0_per_vcycle=1),
        K2a=sum(3 * (1 + 2 * s["v_iters"]) for s in hist), K3=len(hist)))
    print(f"tgv256 mg bf16 kinetic energy after steps 0, 5: "
          f"{energies[0]:.8f}, {energies[1]:.8f}; float32 V-cycle (phase 8) "
          f"after 0, 1, 4: " + ", ".join(f"{e:.8f}" for e in
                                         tgv32.smoke_report["energies"][:3]))
    if energies[1] > energies[0]:
        raise AssertionError(f"kinetic energy grew: {energies}")
    _report_mg("tgv256 mg bf16", tgv, elapsed, 4, profile_steps=2)
    _beside_f32("tgv256 mg bf16", tgv, tgv32)
    tgv.close()
    for name, make in (("flagship", flagship_config),
                       ("sphere", sphere_config)):
        solver = DecoupledIBPMSolver(make(os.path.join(tmp, f"bf16_{name}"),
                                          fdm=False, mg=mg), device=DEVICE)
        check_lp(solver, True)
        counts += _bf16_system(f"{name} mg bf16", solver)
        solver.close()
    return counts


def _vcycle_inputs(solver) -> list:
    """Record the bfloat16 bits of every V-cycle input of ``solver``'s
    low-precision hierarchy (on the host)."""
    import torch

    lp = solver.poisson_mg_lp
    seen, vcycle = [], lp.vcycle

    def recorded(lvl, rhs):
        if lvl == 0:
            seen.append(rhs.detach().cpu().view(torch.int16).clone())
        return vcycle(lvl, rhs)

    lp.vcycle = recorded
    return seen


def _phase13_small(tmp: str) -> None:
    """(c) Small cases in float64 on the card against the CPU: the pinned
    periodic TGV2D at 32^2 (its FDM solve by FFT), the 16^3 TGV with
    ``fdm.fft: true``, and the 32^2 cylinder with ``fdm: false`` and the
    bfloat16 V-cycle under the float64 solve; fields to 1e-9, iteration
    counts and ok flags equal.  The bfloat16 kernels equal their twins, so
    only the float64 rounding of the V-cycle's input can part the two
    runs: the inputs are compared and the first that differs is
    printed."""
    from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver
    from petibm_tpu_torch.solvers.navierstokes import NavierStokesSolver

    def pinned(dev, tag):
        s = NavierStokesSolver(tgv2d_config(
            os.path.join(tmp, f"tgv2d_pinned_{tag}"), nt=10,
            dtype="float64", poissonSolver=_solver_opts(
                20000, rtol=0.0, pc="mg", type="GPU")), device=dev)
        if not s.is_ref_p or s._poisson_fdm_pinned._fft_axes != (0, 1):
            raise AssertionError("the pinned FDM solve takes no FFT")
        return s

    _cuda_vs_cpu("tgv2d 32^2 pinned fft", pinned, ("p",))

    def tgv_fft(dev, tag):
        s = NavierStokesSolver(tgv3d_config(
            os.path.join(tmp, f"tgv16_fft_{tag}"), n=16, nt=10, dt=0.05,
            dtype="float64", fdm={"velocity": False, "fft": True}),
            device=dev)
        tgv3d_initial_state(s)
        return s

    _cuda_vs_cpu("tgv 16^3 fft", tgv_fft, ("p",))

    inputs = {}

    def cylinder(dev, tag):
        s = DecoupledIBPMSolver(small_config(
            os.path.join(tmp, f"small_bf16_{tag}"), nt=10, dtype="float64",
            fdm=False, mg={"dtype": "bfloat16"}), device=dev)
        inputs[tag] = _vcycle_inputs(s)
        return s

    try:
        _cuda_vs_cpu("32^2 mg bf16 (float64 solve)", cylinder, ("p", "f"))
    finally:
        card, cpu = inputs.get("card", []), inputs.get("cpu", [])
        differ = [i for i, (a, b) in enumerate(zip(card, cpu))
                  if not bool((a == b).all())]
        print(f"32^2 mg bf16: {len(card)} / {len(cpu)} V-cycles on the card"
              f" / the CPU, {len(differ)} with inputs that differ in "
              "bfloat16" + "".join(
                  f"; V-cycle {i}: {_bits_apart(card[i], cpu[i])}"
                  for i in differ[:3]))


def _bits_apart(a, b) -> str:
    """Where two bfloat16 tensors (as int16 bits) differ: how many values,
    and the largest of them against the largest of ``b``."""
    import torch

    fa, fb = (t.view(torch.bfloat16).double() for t in (a, b))
    where = a != b
    top = float(torch.maximum(fa[where].abs(), fb[where].abs()).max())
    return (f"{int(where.sum())} values, the largest {top:.3e} against "
            f"{float(fb.abs().max()):.3e}")


def phase13_fft_bf16(tmp: str, tgv, mg_solvers) -> list:
    """(a) the FFT TGV, (b) the bfloat16 MG cells, (c) small cases card vs
    CPU (the module docstring); returns the launches of (a) and (b)."""
    t0 = time.perf_counter()
    counts = [_phase13_fft_tgv(tmp, tgv)]
    print(f"phase 13 (a) done at {time.perf_counter() - t0:.1f} s into the "
          "phase")
    counts += _phase13_bf16_cells(tmp, *mg_solvers)
    print(f"phase 13 (b) done at {time.perf_counter() - t0:.1f} s into the "
          "phase")
    _phase13_small(tmp)
    return counts


def _hold_at_shape(solver, applies: int) -> dict:
    """K1 (the pressure), K2a (u, v, w) and K3 at the solver's 3D shape
    against their twins bit for bit, float32, timed beside their bounds,
    K1 and K2a (u) also beside ``torch.sparse.mm`` on their CSR operators;
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
    phi = randn(level.shape)
    out = {"K1": _hold_k1(f"K1 {label} p", level, phi, applies)}
    _library(f"K1 {label} p", out["K1"], _k1_csr(level), phi,
             cs.poisson_apply_separable(phi, level), applies)
    A = cs.make_cuda_momentum(mesh, bcs, solver.dt, 0.5 * solver.nu,
                              dtype=torch.float32, device=cuda)
    for c, comp in enumerate("uvw"):
        f = randn(mesh.shape(c))
        rec = _hold_k2(f"K2a {label} {comp}", f, A.vecs[comp], A.periodic,
                       None, 1e-6, applies)
        if comp == "u":
            _library(f"K2a {label} u", rec,
                     _k2_csr(tuple(f.shape), A.vecs[comp], A.periodic), f,
                     cs.zblocked_helmholtz_apply(f, A.vecs[comp],
                                                 A.periodic), applies)
        out.setdefault("K2a", rec)
    out["K3"] = _hold_k3("K3 refined sphere", mesh, bcs,
                         {k: randn(mesh.shape(c))
                          for c, k in enumerate("uvw")}, applies)
    return out


def _tree_diff(a, b) -> float:
    """The largest absolute difference between two states' tensors (inf
    where a shape or dtype differs)."""
    import torch
    from torch.utils import _pytree as pytree

    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    if sa != sb:
        return math.inf
    worst = 0.0
    for x, y in zip(la, lb):
        if x.shape != y.shape or x.dtype != y.dtype:
            return math.inf
        if x.numel():
            d = (x.double() - y.double()).abs().max()
            worst = max(worst, float(torch.nan_to_num(d, nan=math.inf)))
    return worst


def _stats_diff(a: list, b: list) -> float:
    """The largest absolute difference between two runs' per-step stats
    (inf where their steps or keys differ)."""
    if len(a) != len(b) or any(x.keys() != y.keys() for x, y in zip(a, b)):
        return math.inf
    return max((abs(float(x[k]) - float(y[k])) for x, y in zip(a, b)
                for k in x), default=0.0)


def _mg_implied(solver, hist: list, level0_per_vcycle: int = 2) -> dict:
    """``_mg_counts`` over the stats ``hist``."""
    vcycles = sum(1 + s["p_iters"] for s in hist)
    sweeps = solver.poisson_mg.sweeps_per_vcycle() * vcycles
    if any(solver.mesh.periodic):
        return {"K6/K7": sweeps, "K2b": level0_per_vcycle * vcycles}
    return {"K4/K5": sweeps, "K1": level0_per_vcycle * vcycles}


def _check_chunk_fits(label: str, solver) -> None:
    """Raise unless the solver's next ``steps_per_dispatch`` steps are one
    chunk (``run()`` runs single steps up to a host event inside them)."""
    k = solver.steps_per_dispatch
    solver.nt += k
    fits = solver._steps_to_host_event() >= k
    solver.nt -= k
    if not fits:
        raise AssertionError(f"{label}: a host event falls inside the "
                             "next chunk")


def _counted_chunk(label: str, solver, implied) -> dict:
    """One chunk of ``solver`` with its launches counted on the device:
    the step captured again with each wrapper's device counter beside
    its kernel (``_kernels.count_on_device``), a chunk run (another while
    one overflows: an overflow's replays are thrown away), its counts
    held to ``implied`` of its stats and the wrappers' host counts to 0
    (a replay enters no wrapper).  The counting graph is dropped with
    the counters: a later chunk of the solver prepares anew.  Returns the
    counts."""
    from petibm_tpu_torch import _kernels

    runner, k = solver._chunk, solver.steps_per_dispatch
    for _ in range(4):
        _check_chunk_fits(label, solver)
        _kernels.count_on_device(DEVICE)
        runner.capture()
        _reset_counts()
        before = solver.chunk_overflows
        solver.nt += k
        solver.run()
        counts = _by_kernel(_kernels.device_launch_counts())
        host = _counts()
        if solver.chunk_overflows == before:
            break
    else:
        raise AssertionError(f"{label}: four counted chunks overflowed")
    solver._chunk = None
    _kernels.count_on_device(None)
    _check_counts(f"{label} chunk on the device (wrappers)", host, {})
    _check_counts(f"{label} chunk on the device",
                  counts, implied(solver.stats_history[-k:]))
    return counts


def _chunk_cell(label: str, solver, nsteps: int, k: int, implied,
                cg_cap: int | None = None, n_single: int = 10) -> dict:
    """One cell of phase 14 from the solver's state: ``nsteps`` steps
    through ``run()`` one at a time, then from the same start ``nsteps``
    through ``run()`` in chunks of ``k`` (the graph captured first,
    outside the timed run; ``cg_cap`` forces every CG loop's cap).  Holds
    the fields and the per-step stats of the two runs at tolerance 0.
    The wrappers count only launches made outside a graph: over each
    chunk, those of the steps an overflow reran through the host driver,
    held to ``implied(stats)`` of those steps.  Then times one more chunk
    (another while one overflows), profiles up to ``n_single`` of k
    single steps (their
    launches held to the stats) and one chunk (``_profile``), and counts
    one chunk's launches on the device (``_counted_chunk``).  Returns the
    cell's record."""
    import torch
    from torch.utils import _pytree as pytree

    from petibm_tpu_torch.solvers.chunk import ChunkRunner

    zero = {key: 0 for key in _counts()}

    def add(total: dict, counts: dict) -> None:
        for key in total:
            total[key] += counts[key]

    start = (pytree.tree_map(torch.clone, solver.state), solver.ite,
             solver.t)
    n0 = len(solver.stats_history)
    solver.steps_per_dispatch = 1
    solver.nt = solver.ite - solver.nstart + nsteps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.run()
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    single = (solver.state, solver.stats_history[n0:])

    solver.state, solver.ite, solver.t = start
    solver.steps_per_dispatch = k
    runner = solver._chunk = ChunkRunner(solver)
    t0 = time.perf_counter()
    runner.prepare()
    if cg_cap is not None:
        runner.caps = [cg_cap if site.kind == "cg" else cap
                       for cap, site in zip(runner.caps, runner.sites)]
        runner.capture()
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    info = dict(runner.info)
    overflows0 = solver.chunk_overflows
    torch.cuda.reset_peak_memory_stats()
    launches = dict(zero)
    chunk_s = 0.0
    for _ in range(nsteps // k):
        before = solver.chunk_overflows
        _reset_counts()
        solver.nt = solver.ite - solver.nstart + k
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.run()
        torch.cuda.synchronize()
        chunk_s += time.perf_counter() - t0
        eager = _counts()
        add(launches, eager)
        rerun = (solver.stats_history[-k:]
                 if solver.chunk_overflows > before else [])
        _check_counts(f"phase 14 {label} chunk steps {solver.ite - k + 1}-"
                      f"{solver.ite} outside a graph (overflow reruns)",
                      eager, implied(rerun))
    peak = torch.cuda.max_memory_allocated()
    chunked = solver.stats_history[n0 + nsteps:]
    field_diff = _tree_diff(single[0], solver.state)
    stats_diff = _stats_diff(single[1], chunked)
    overflows = solver.chunk_overflows - overflows0
    # the graph writes each step's new state back into its buffers: one
    # copy of the state a step (two more a chunk: in and out)
    leaves = pytree.tree_leaves(solver.state)
    state_mb = sum(t.numel() * t.element_size() for t in leaves) / 2 ** 20

    def copy_state(_):
        for dst, src in zip(runner.static, leaves):
            dst.copy_(src)

    copy_ms = _time_ms(copy_state, None, applies=20, batch=5)[0]
    # one more chunk, timed alone: the captured graph's own pace, apart
    # from the steps an overflow reran (another chunk while one overflows)
    for _ in range(4):
        before = solver.chunk_overflows
        solver.nt += k
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.run()
        torch.cuda.synchronize()
        steady_ms = (time.perf_counter() - t0) / k * 1e3
        if solver.chunk_overflows == before:
            break
    else:
        raise AssertionError(f"phase 14 {label}: four chunks overflowed")

    # one chunk and up to n_single single steps profiled, in one call: the
    # device time of the graph beside the eager step's (the single steps
    # last: a chunk is cut at a host event their count would misalign)
    _check_chunk_fits(f"phase 14 {label}", solver)
    prof_chunk = _profile(solver, k)
    counted = _counted_chunk(f"phase 14 {label}", solver, implied)
    add(launches, counted)
    solver.steps_per_dispatch = 1
    _reset_counts()
    n_single = min(k, n_single)
    prof_single = _profile(solver, n_single)
    counts = _counts()
    _check_counts(f"phase 14 {label} {n_single} single steps", counts,
                  implied(solver.stats_history[-n_single:]))
    add(launches, counts)
    record = {
        "cell": label, "steps": nsteps, "k": k,
        "single_ms_step": single_s / nsteps * 1e3,
        "chunked_ms_step": chunk_s / nsteps * 1e3,
        "next_chunk_ms_step": steady_ms,
        "single_profile": prof_single, "chunked_profile": prof_chunk,
        "max_abs_diff_fields": field_diff, "max_abs_diff_stats": stats_diff,
        "prepare_s": prepare_s, "warmup_s": info.get("warmup_s"),
        "capture_s": info.get("capture_s"),
        "instantiate_s": info.get("instantiate_s"),
        "nodes": info.get("nodes"), "top_nodes": info.get("top_nodes"),
        "capture_peak_mb": info.get("peak_bytes", 0) / 2 ** 20,
        "capture_held_mb": info.get("held_bytes", 0) / 2 ** 20,
        "run_peak_mb": peak / 2 ** 20, "state_mb": state_mb,
        "state_copy_ms": copy_ms,
        "caps": info.get("caps"), "caps_after": list(runner.caps),
        "overflows_after": solver.chunk_overflows - overflows0 - overflows,
        "sites": [site.kind for site in runner.sites],
        "overflows": overflows, "counted_chunk_launches": counted,
        "launches": launches}
    print(f"phase 14 {label}: {nsteps} steps, k {k}: max abs diff fields "
          f"{field_diff:g}, stats {stats_diff:g} (tolerance 0); "
          f"{record['single_ms_step']:.3f} ms/step single, "
          f"{record['chunked_ms_step']:.3f} chunked, one more chunk "
          f"{steady_ms:.3f} (synchronised); graph {info.get('nodes')} nodes "
          f"({info.get('top_nodes')} top level), warm-up "
          f"{info.get('warmup_s', 0):.2f} s, capture "
          f"{info.get('capture_s', 0):.2f} s, instantiate "
          f"{info.get('instantiate_s', 0):.2f} s; caps {record['caps']} "
          f"-> {record['caps_after']} of sites {record['sites']}; "
          f"overflows {overflows}; memory: capture peak "
          f"{record['capture_peak_mb']:.1f} MB, held "
          f"{record['capture_held_mb']:.1f} MB, run peak "
          f"{record['run_peak_mb']:.1f} MB; the state {state_mb:.1f} MB, "
          f"one copy of it {copy_ms:.4f} ms device")
    for name, p in ((f"{n_single} single steps", prof_single),
                    (f"a chunk of {k}", prof_chunk)):
        print(f"phase 14 {label} profile of {name}: "
              f"{p['wall_ms_step']:.3f} ms/step wall, "
              f"{p['device_ms_step']:.4f} device, busy share "
              f"{p['busy']:.4f}; {p['kernels_step']:.1f} kernels a step, "
              f"set_conditional {p['set_conditional_ms_step']:.4f} ms/step "
              "device")
    if field_diff != 0.0 or stats_diff != 0.0:
        raise AssertionError(f"phase 14 {label}: chunked differs from the "
                             f"single steps ({field_diff}, {stats_diff})")
    return record


def phase14_chunked(tmp: str, card: str) -> list:
    """``stepsPerDispatch``: each cell from one start, k steps a chunk
    (one CUDA graph of the step replayed k times, one host read), beside
    the single steps of the same steps (``_chunk_cell``): (a) the
    flagship, 100 steps, k 50; (b) the sphere, 50, 25; (c) the 256^3 TGV
    (FDM pressure), 20, 10; (d) the coupled Re=550, 100, 50; (e) the
    oscillating cylinder, 100, 50 (its force solve's fallbacks equal);
    (f) the flagship MG-CG, 10, 5; (g) (f) again with the CG loop's cap
    forced to 4: it overflows, reruns and recaptures and still equals
    the single steps; then the coupled Re=550 with ``fdm: false``, one
    k = 2 chunk for its node count and capture time; (i) the oscillating
    cylinder on the windowed delta engine (its window box the whole
    grid, no host read a step), 20, 10, K1 counted on the device in its
    graph.  Returns each cell's launches: the wrappers' counts outside
    the graph and the profiled chunk's kernel events."""
    import torch

    from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver
    from petibm_tpu_torch.solvers.ibpm import IBPMSolver
    from petibm_tpu_torch.solvers.navierstokes import NavierStokesSolver
    from petibm_tpu_torch.solvers.rigidkinematics import RigidKinematicsSolver

    t_phase = time.perf_counter()
    records = []

    def cell(label, solver, nsteps, k, implied, **kw):
        records.append(_chunk_cell(label, solver, nsteps, k, implied, **kw))
        print(f"phase 14 {label} done at "
              f"{time.perf_counter() - t_phase:.1f} s into the phase "
              f"({card})")

    def k1_fdm(hist):
        return {"K1": sum(2 + s["p_iters"] for s in hist)}

    flag = DecoupledIBPMSolver(flagship_config(
        os.path.join(tmp, "c_flag"), nt=0), device=DEVICE)
    cell("(a) flagship", flag, 100, 50, k1_fdm)
    flag.close()

    sph = DecoupledIBPMSolver(sphere_config(os.path.join(tmp, "c_sph"),
                                            nt=0), device=DEVICE)
    cell("(b) sphere", sph, 50, 25, lambda hist: {
        "K1": sum(2 + s["p_iters"] for s in hist),
        "K2a": sum(3 * (2 + s["v_iters"]) for s in hist), "K3": len(hist)})
    sph.close()

    tgv = NavierStokesSolver(tgv3d_config(os.path.join(tmp, "c_tgv"), nt=0),
                             device=DEVICE)
    tgv3d_initial_state(tgv)
    cell("(c) tgv256", tgv, 20, 10, lambda hist: {
        "K2a": sum(3 * (1 + 2 * s["v_iters"]) for s in hist),
        "K2b": sum(2 + s["p_iters"] for s in hist), "K3": len(hist)})
    tgv.close()
    del tgv
    torch.cuda.empty_cache()

    re550 = IBPMSolver(re550_config(os.path.join(tmp, "c_re550"), nt=0),
                       device=DEVICE)
    cell("(d) re550", re550, 100, 50, lambda hist: {})
    re550.close()

    osc = RigidKinematicsSolver(oscillating_config(
        os.path.join(tmp, "c_osc"), nt=0), device=DEVICE)
    cell("(e) oscillating", osc, 100, 50, k1_fdm)
    hist = osc.stats_history
    fallbacks = [sum(int(s["fallback"]) for s in part)
                 for part in (hist[:100], hist[100:200])]
    print(f"phase 14 (e) oscillating: force-solve fallbacks single "
          f"{fallbacks[0]}, chunked {fallbacks[1]}")
    if fallbacks[0] != fallbacks[1]:
        raise AssertionError("phase 14 (e): the fallbacks differ")
    records[-1]["fallbacks"] = fallbacks
    osc.close()

    mg = DecoupledIBPMSolver(flagship_config(
        os.path.join(tmp, "c_mg"), nt=0, fdm=False), device=DEVICE)

    def mg_implied(hist):
        return _mg_implied(mg, hist)

    cell("(f) flagship mg", mg, 10, 5, mg_implied)
    # (g) from (f)'s end, the CG cap forced to 4
    cell("(g) flagship mg, CG cap 4", mg, 5, 5, mg_implied, cg_cap=4)
    if records[-1]["overflows"] != 1:
        raise AssertionError("phase 14 (g): the forced cap did not overflow "
                             "once")
    mg.close()

    # the coupled fdm: false step: one k = 2 chunk for its graph's size
    cmg = IBPMSolver(re550_config(os.path.join(tmp, "c_re550_mg"), nt=0,
                                  fdm=False), device=DEVICE)
    # one single step profiled: ~50 000 kernel events a step
    cell("(h) re550 mg", cmg, 2, 2, lambda hist: _mg_implied(cmg, hist, 1),
         n_single=1)
    cmg.close()

    # the moving body on the windowed engine: the Krylov force solve
    wosc = RigidKinematicsSolver(oscillating_config(
        os.path.join(tmp, "c_osc_win"), nt=0, deltaEngine="windowed"),
        device=DEVICE)
    if not wosc.delta.windowed:
        raise AssertionError("phase 14 (i): not the windowed engine")
    cell("(i) oscillating windowed", wosc, 20, 10, k1_fdm)
    wosc.close()
    print(json.dumps({"chunked": {"device": card, "cells": [
        {k: v for k, v in r.items() if k != "launches"} for r in records]}}))
    return [r["launches"] for r in records]


#: phase 15's cells: (name, config function, mesh shape, steps, dtype,
#: solver, extra parameters; "probes" there is the config's probes
#: node, "chunk" a chunk's steps: the cell's steps again from the same
#: start in chunks, ``_p15_chunked``).  The coupled cells set coupledDirect: false,
#: which their decomposed runs take anyway (no direct solve under a
#: mesh, JAX ibpm.py:97-101), so that the single-rank reference runs the
#: same outer CG
P15_CELLS = (
    ("flagship_1x2", "flagship_config", [1, 2], 11, "float32", "decoupled",
     {"chunk": 5}),
    ("flagship_2x1", "flagship_config", [2, 1], 5, "float32", "decoupled",
     {}),
    ("sphere_1x2", "sphere_config", [1, 2], 5, "float32", "decoupled", {}),
    ("cylinder_f64", "small_config", [1, 2], 3, "float64", "decoupled", {}),
    ("flagship_mg_1x2", "flagship_config", [1, 2], 3, "float32",
     "decoupled", {"fdm": False, "chunk": 2}),
    ("re550_coupled_1x2", "re550_config", [1, 2], 1, "float32", "coupled",
     {"coupledDirect": False}),
    ("oscillating_1x2", "oscillating_config", [1, 2], 5, "float32",
     "moving", {}),
    ("mg_f64", "small_config", [1, 2], 3, "float64", "decoupled",
     {"fdm": False}),
    ("coupled_f64", "small_config", [1, 2], 2, "float64", "coupled",
     {"coupledDirect": False,
      "poissonSolver": _solver_opts(atol=1e-12, rtol=0.0)}),
    ("moving_f64", "small_moving_config", [1, 2], 3, "float64", "moving",
     {}),
    # PR 17: the 3-axis mesh (z cut), the contraction core of the FDM,
    # the windowed engine and the probes on the ranks
    ("sphere_3axis_2x1x1", "sphere_config", [2, 1, 1], 3, "float32",
     "decoupled", {}),
    ("sphere_windowed_1x2", "sphere_config", [1, 2], 3, "float32",
     "decoupled", {"deltaEngine": "windowed"}),
    ("flagship_norepart_probes_1x2", "flagship_config", [1, 2], 10,
     "float32", "decoupled",
     {"fdm": {"repartition": False}, "probes": [
         {"type": "POINT", "field": "p", "path": "probe-p.txt",
          "loc": [1.0, 0.1]},
         {"type": "VOLUME", "field": "u", "viewer": "ascii",
          "path": "probe-u.txt", "n_monitor": 5,
          "box": {"x": [-0.75, 0.75], "y": [-0.75, 0.75]}}]}),
    ("sphere_mg_2x1x1", "sphere_config", [2, 1, 1], 1, "float32",
     "decoupled", {"fdm": False}),
    ("small3d_3axis_f64", "small3d_config", [2, 1, 1], 3, "float64",
     "decoupled", {}),
    ("small3d_mg_3axis_f64", "small3d_config", [2, 1, 1], 3, "float64",
     "decoupled", {"fdm": False}),
    ("windowed_probes_norepart_f64", "small_config", [1, 2], 3, "float64",
     "decoupled",
     {"deltaEngine": "windowed", "fdm": {"repartition": False}, "probes": [
         {"type": "POINT", "field": "p", "path": "probe-p.txt",
          "loc": [0.8, 0.1]},
         {"type": "VOLUME", "field": "u", "viewer": "ascii",
          "path": "probe-u.txt", "box": {"x": [-1.0, 1.0],
                                         "y": [-1.0, 1.0]}}]}),
    ("moving_windowed_f64", "small_moving_config", [1, 2], 3, "float64",
     "moving", {"deltaEngine": "windowed"}))
#: cells whose float32 fields are held to 3 times the single rank's spread
#: against itself from an initial u one ulp up, where that exceeds 1e-4:
#: the coupled outer CG stops near its float32 floor (atol 1e-6 at
#: Re=550), so any other order of sums moves p and f by about as much
P15_SPREAD = ("re550_coupled_1x2",)
#: cells whose single-rank reference runs the ranks' arithmetic, the
#: stencil closures and the twins (``disablePallas``; the twins of K4-K7
#: are bit-equal to the kernels): K1-K3 are off under a mesh, and the
#: sphere's first step from its uniform start has a momentum residual at
#: the rounding floor, where K2a's rounding and the closure's decide
#: between 2 and 0 BiCGStab iterations (the card, PR 17)
P15_STENCIL_REFERENCE = ("sphere_mg_2x1x1",)
#: two ranks on one card: NCCL refuses two ranks of a communicator on one
#: device ("Duplicate GPU detected", scripts/probe_nccl_one_card.py) unless
#: each rank has a host id of its own; the socket transport on loopback
#: then carries them
P15_NCCL_ENV = {"NCCL_SOCKET_IFNAME": "lo", "NCCL_IB_DISABLE": "1",
                "NCCL_P2P_DISABLE": "1", "NCCL_SHM_DISABLE": "1"}


def small_moving_config(tmp: str, **params) -> dict:
    """The 32^2 cylinder of ``small_config`` oscillating in x (phase 11's
    small moving body: f 1, KC 2)."""
    cfg = small_config(tmp, **params)
    cfg["bodies"][0]["kinematics"] = {"type": "oscillation", "f": 1.0,
                                      "D": 1.0, "KC": 2.0}
    return cfg


def _p15_solver(cfg: dict, device: str, kind: str):
    from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver
    from petibm_tpu_torch.solvers.ibpm import IBPMSolver
    from petibm_tpu_torch.solvers.rigidkinematics import RigidKinematicsSolver

    cls = {"decoupled": DecoupledIBPMSolver, "coupled": IBPMSolver,
           "moving": RigidKinematicsSolver}[kind]
    return cls(cfg, device=device)


def _p15_sweeps(solver) -> tuple:
    """(line sweeps of one V-cycle, whether its levels are periodic); (0,
    False) where the pressure solve runs no V-cycle."""
    mg = getattr(solver, "poisson_mg", None)
    if mg is None or (getattr(solver, "poisson_fdm", None) is not None
                      and getattr(solver, "_fdm_mode", None) == "direct"):
        return 0, False
    return mg.sweeps_per_vcycle(), any(mg.levels[0].periodic)


def _p15_implied(sweeps: int, periodic: bool, stats: list) -> dict:
    """The launches a rank's stats imply: one V-cycle a CG iteration and
    one more, each ``sweeps`` launches of K4/K5 (K6/K7 on periodic
    levels); K1-K3 none (off under a mesh, as in the JAX package)."""
    n = sweeps * sum(1 + int(s["p_iters"]) for s in stats)
    want = {"K1": 0, "K2a": 0, "K2b": 0, "K3": 0, "K4/K5": 0, "K6/K7": 0}
    want["K6/K7" if periodic else "K4/K5"] = n
    return want


def _p15_steps(solver, steps: int) -> dict:
    """``steps`` steps from the solver's start: each step's stats, the
    ms/step of steps 2.. (of step 1 in a 1-step cell; host clock,
    synchronized), the collectives of
    those steps and the wrappers' kernel launches over all of them; the
    probes monitored after each step."""
    import torch

    from petibm_tpu_torch.parallel import counters, reset_counters

    sync = (torch.cuda.synchronize if solver.device.type == "cuda"
            else (lambda: None))
    stats = []
    if solver.device.type == "cuda":
        _reset_counts()
    # steps 2.. timed (the only step of a 1-step cell)
    first = min(1, steps - 1)
    t0 = None
    for k in range(steps):
        if k == first:
            sync()
            reset_counters()
            t0 = time.perf_counter()
        solver.state, s = solver._step_fn(solver.state)
        stats.append({key: float(v) for key, v in s.items() if key != "f"})
        if solver.probes:
            # the step's time and index, as ``advance`` keeps them
            solver.t += solver.dt
            solver.ite += 1
            solver.monitor_probes()
    sync()
    ms = (time.perf_counter() - t0) * 1e3 / (steps - first)
    comm = counters()
    launches = _counts() if solver.device.type == "cuda" else {}
    return {"stats": stats, "ms": ms, "comm": comm, "launches": launches}


def _p15_chunked(solver, steps: int, k: int) -> dict:
    """Of ``steps`` single steps (``advance``, the host driver), the first
    ``steps - n`` spin the start up (n the most whole chunks of ``k`` in
    ``steps - 1``: the caps come from a warm-up step past the impulsive
    first one), then from where they left the state the last n again in
    chunks of ``k`` (the step captured as
    one CUDA graph on each rank, its loop copies masked: an IF node's
    body takes no NCCL collective) with the launches counted on the
    device (``_kernels.count_on_device``: every launch, and those whose
    results the masked copies kept).  Returns
    the single steps' stats, collectives and launches (as
    ``_p15_steps``), each run's ms/step (host clock, synchronized), the
    chunks' stats and device counts, and whether this rank's state came
    out bit for bit as the single steps left it."""
    import torch
    from torch.utils import _pytree as pytree

    from petibm_tpu_torch import _kernels
    from petibm_tpu_torch.parallel import counters, reset_counters
    from petibm_tpu_torch.solvers.chunk import ChunkRunner

    cuda = solver.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    n = k * ((steps - 1) // k)
    if cuda:
        _reset_counts()
    for _ in range(steps - n):
        solver.advance()
    start = (pytree.tree_map(torch.clone, solver.state), solver.ite,
             solver.t)
    n0 = len(solver.stats_history)
    reset_counters()
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        solver.advance()
    sync()
    single_ms = (time.perf_counter() - t0) * 1e3 / n
    comm = counters()
    launches = _counts() if cuda else {}
    single_state = solver.state
    single = solver.stats_history[n0:]

    solver.state, solver.ite, solver.t = start
    solver.steps_per_dispatch = k
    runner = solver._chunk = ChunkRunner(solver)
    if cuda:
        # the graph captured with the counters beside its kernels; the
        # warm-up step's launches zeroed after it
        _kernels.count_on_device(solver.device)
    sync()
    t0 = time.perf_counter()
    runner.prepare()
    sync()
    prepare_s = time.perf_counter() - t0
    if cuda:
        _kernels.zero_device_launch_counts()
        _reset_counts()
    reset_counters()
    sync()
    t0 = time.perf_counter()
    for _ in range(n // k):
        solver.advance_chunk()
    sync()
    chunk_ms = (time.perf_counter() - t0) * 1e3 / n
    chunk_comm = counters()
    hist = solver.stats_history
    out = {"stats": [{key: float(v) for key, v in s.items() if key != "ite"}
                     for s in hist[:n0 + n]],
           "chunk_stats": [{key: float(v) for key, v in s.items()
                            if key != "ite"} for s in hist[n0 + n:]],
           "single_stats": [{key: float(v) for key, v in s.items()
                             if key != "ite"} for s in single],
           "ms": single_ms, "chunk_ms": chunk_ms, "prepare_s": prepare_s,
           "comm": comm, "chunk_comm": chunk_comm, "launches": launches,
           "chunk_host_launches": _counts() if cuda else {},
           "overflows": solver.chunk_overflows, "masked": runner.masked,
           "caps": list(runner.caps),
           "sites": [site.kind for site in runner.sites],
           "same_bits": all(torch.equal(a, b) for a, b in zip(
               pytree.tree_leaves(single_state),
               pytree.tree_leaves(solver.state)))}
    if cuda:
        out["chunk_launches"] = _by_kernel(_kernels.device_launch_counts())
        out["chunk_launches_kept"] = _by_kernel(
            _kernels.device_launch_counts(kept=True))
        _kernels.count_on_device(None)
    solver._chunk = None
    return out


def _p15_fields(solver) -> dict:
    from petibm_tpu_torch.convert import state_to_numpy

    full = state_to_numpy(solver.state, solver.part)
    out = dict(full["q"], p=full["p"])
    if "f" in full:
        out["f"] = full["f"]
    return out


def phase15_rank(spec_path: str, rank: int) -> None:
    """One rank of phase 15 (run as ``chip_smoke.py --phase15-rank SPEC
    RANK``): every cell of the spec decomposed on its mesh, through the
    solver API; writes its timings and counters, and rank 0 the gathered
    fields, under the spec's ``out``."""
    import numpy as np
    import torch

    with open(spec_path) as fh:
        spec = json.load(fh)
    torch.set_num_threads(1)
    report = {}
    for cell in spec["cells"]:
        cfg = cell["config"]
        cfg["parameters"]["sharding"] = {"nDevices": spec["world"],
                                         "shape": cell["shape"]}
        cfg["parameters"]["distributed"] = {
            "coordinator": f"localhost:{spec['port']}",
            "numProcesses": spec["world"], "processId": rank}
        solver = _p15_solver(cfg, spec["device"], cell["solver"])
        if cell.get("chunk"):
            run = _p15_chunked(solver, cell["steps"], cell["chunk"])
        else:
            run = _p15_steps(solver, cell["steps"])
        fields = _p15_fields(solver)
        solver.close()
        report[cell["name"]] = {k: v for k, v in run.items()
                                if k not in ("probes",)}
        report[cell["name"]]["sweeps"] = _p15_sweeps(solver)
        mg = getattr(solver, "poisson_mg", None)
        report[cell["name"]]["mg_levels"] = [
            list(lb.local_shape()) for lb in getattr(mg, "blocks", [])]
        report[cell["name"]]["backend"] = solver.part.pmesh.backend
        fdm = getattr(solver, "poisson_fdm", None)
        report[cell["name"]]["fdm_core"] = (type(fdm._core).__name__
                                            if fdm is not None else None)
        report[cell["name"]]["device"] = str(solver.device)
        if rank == 0:
            np.savez(os.path.join(spec["out"], f"{cell['name']}.npz"),
                     **fields)
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as fh:
        json.dump(report, fh)
    import torch.distributed as dist

    dist.destroy_process_group()


def _p15_launch(spec: dict, timeout: float) -> list:
    """The ranks as processes of this script, started together; their
    reports by rank.  Any rank that fails, or does not end within
    ``timeout`` seconds, fails the phase; every rank is stopped."""
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        spec["port"] = sk.getsockname()[1]
    path = os.path.join(spec["out"], "spec.json")
    with open(path, "w") as fh:
        json.dump(spec, fh)
    procs = []
    for rank in range(spec["world"]):
        env = dict(os.environ)
        if spec["device"].startswith("cuda"):  # NCCL
            env.update(P15_NCCL_ENV, NCCL_HOSTID=f"petibm-rank-{rank}")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--phase15-rank",
             path, str(rank)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    errors, deadline = [], time.perf_counter() + timeout
    try:
        for rank, proc in enumerate(procs):
            try:
                _, err = proc.communicate(
                    timeout=max(deadline - time.perf_counter(), 1.0))
            except subprocess.TimeoutExpired:
                errors.append(f"rank {rank} did not end within {timeout} s")
                continue
            if proc.returncode != 0:
                errors.append(f"rank {rank} exited {proc.returncode}:\n"
                              f"{err[-4000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    if errors:
        raise AssertionError("phase 15: " + "\n".join(errors))
    reports = []
    for rank in range(spec["world"]):
        with open(os.path.join(spec["out"], f"rank{rank}.json")) as fh:
            reports.append(json.load(fh))
    return reports


def _probe_numbers(path: str):
    """The numbers of an ASCII probe file, in order (its words dropped)."""
    import numpy as np

    out = []
    with open(path) as fh:
        for word in fh.read().split():
            try:
                out.append(float(word))
            except ValueError:
                pass
    return np.array(out)


def _p15_iters(dec: list, ref: list) -> tuple:
    """The v/p/f iteration counts of each step of both runs: the share
    of steps where all three are equal, and the steps where they differ
    (with both runs' counts)."""
    keys = [k for k in ("v_iters", "p_iters", "f_iters") if k in ref[0]]
    differ = [(n + 1, [int(d[k]) for k in keys], [int(r[k]) for k in keys])
              for n, (d, r) in enumerate(zip(dec, ref))
              if any(d[k] != r[k] for k in keys)]
    return 1.0 - len(differ) / len(ref), differ


def _p15_chunk_record(name: str, k: int, reports: list,
                      failures: list) -> dict:
    """A chunked cell's ranks (``_p15_chunked``): each rank's state bit
    for bit as its single steps left it, the chunks' stats equal to the
    single steps', no overflow, no launch outside the graph, and on the
    card the launches each rank's graph kept (masked copies) equal to
    what its chunk stats imply; its ms/step chunked beside single."""
    runs = [r[name] for r in reports]
    rec = {"k": k, "same_bits_ranks": [r["same_bits"] for r in runs],
           "ms_per_step_single_ranks": [r["ms"] for r in runs],
           "ms_per_step_chunked_ranks": [r["chunk_ms"] for r in runs],
           "prepare_s_ranks": [r["prepare_s"] for r in runs],
           "masked": runs[0]["masked"], "caps": runs[0]["caps"],
           "sites": runs[0]["sites"],
           "overflows_ranks": [r["overflows"] for r in runs],
           "stats_diff": max(_stats_diff(r["single_stats"],
                                         r["chunk_stats"]) for r in runs),
           "chunk_collectives_rank0": runs[0]["chunk_comm"]}
    if not all(rec["same_bits_ranks"]) or rec["stats_diff"] != 0.0:
        failures.append(f"{name}: chunked differs from the single steps "
                        f"(bits {rec['same_bits_ranks']}, stats "
                        f"{rec['stats_diff']})")
    if any(rec["overflows_ranks"]):
        failures.append(f"{name}: a chunk overflowed "
                        f"{rec['overflows_ranks']}")
    if DEVICE.startswith("cuda"):
        rec["rank_graph_launches"] = [r["chunk_launches"] for r in runs]
        rec["rank_graph_launches_kept"] = [r["chunk_launches_kept"]
                                           for r in runs]
        rec["rank_kept_implied"] = [
            _p15_implied(*r["sweeps"], r["chunk_stats"]) for r in runs]
        host = [r["chunk_host_launches"] for r in runs]
        if any(any(v for v in h.values()) for h in host):
            failures.append(f"{name}: launches outside the graph {host}")
        if rec["rank_graph_launches_kept"] != rec["rank_kept_implied"]:
            failures.append(
                f"{name}: the graphs kept {rec['rank_graph_launches_kept']}"
                f" launches, the chunk stats imply "
                f"{rec['rank_kept_implied']}")
    print(f"phase 15 {name} chunked, k {k}: ms/step single "
          f"{rec['ms_per_step_single_ranks']}, chunked "
          f"{rec['ms_per_step_chunked_ranks']} (per rank; loop copies "
          f"{'masked' if rec['masked'] else 'guarded'}, caps "
          f"{rec['caps']}), bit-equal "
          f"{rec['same_bits_ranks']}, graph launches "
          f"{rec.get('rank_graph_launches')}, kept "
          f"{rec.get('rank_graph_launches_kept')}")
    return rec


def phase15_distributed(tmp: str, card: str) -> None:
    """The decomposed step (``parameters.sharding``; ``parallel/``): two
    ranks on the one card, processes of this script, each from the same
    start as a single-rank run, through the solver API (``P15_CELLS``):
    the flagship on a [1, 2] mesh and on [2, 1], 5 steps each; the
    sphere of phase 5 on [1, 2], 5 steps; the flagship with ``fdm:
    false`` (the decomposed V-cycle: levels 450^2, 225^2 and 113^2 on the
    blocks, 57^2 and below whole), 1 step; the coupled Re=550 of phase
    10, 1 step; the oscillating cylinder of phase 11, 5 steps; the
    sphere on the 3-axis [2, 1, 1] mesh (z cut: the FDM's contraction
    core), 3 steps, and with ``fdm: false`` (K5 on z pencils), 1 step;
    the sphere with ``deltaEngine: windowed`` on [1, 2], 3 steps; the
    flagship with ``fdm.repartition: false``, a point probe of p in the
    near wake and a volume probe of u around the body, 10 steps: u, v(,
    w), p, f and the probe files within 1e-4 of max |field| of the
    single-rank card run (float32; for the cells of ``P15_SPREAD``,
    within 3 times the single rank's own spread from an initial u one
    ulp up, where that is more) and the v/p/f iterations equal on at
    least 95% of the steps (the others listed); float64 cells on the
    card against a single-rank CPU run, 2-3 steps, fields, forces and
    probe files within 1e-9, the iterations (and a moving body's
    fallbacks) equal on every step: the 32^2 cylinder, its ``fdm:
    false``, coupled and moving variants, the 24x20x16 sphere on [2, 1,
    1] with the FDM and with ``fdm: false``, the cylinder with the
    windowed engine, ``fdm.repartition: false`` and the two probes, and
    the moving cylinder on the windowed engine.  The flagship on [1, 2]
    (11 steps) and its ``fdm: false`` (3 steps) also run chunked
    (``_p15_chunked``: after a spin-up step, 10 and 2 steps again in
    chunks of 5 and 2, each rank's graph with its loop copies masked),
    each rank's state bit-equal to its single steps, the MG cell's K4/K5
    counted on the card inside the graphs as the chunk's stats imply
    (``_p15_chunk_record``).  Prints the backend,
    the FDM core, ms/step of each rank beside the single rank's (two
    ranks share one card: not a scaling number), and the halo
    exchanges, all-reduces, all-to-alls and reduce-scatters a step with
    the bytes this rank sends.  On every rank K1-K3 launch no time (the
    JAX package's gates under a mesh) and K4/K5 (K6/K7 on periodic
    levels) as often as its V-cycles imply."""
    import numpy as np
    import torch

    funcs = {"flagship_config": flagship_config,
             "sphere_config": sphere_config, "small_config": small_config,
             "re550_config": re550_config,
             "oscillating_config": oscillating_config,
             "small_moving_config": small_moving_config,
             "small3d_config": small3d_config}
    out = os.path.join(tmp, "p15")
    os.makedirs(out)
    cells = []
    for name, func, shape, steps, dtype, kind, extra in P15_CELLS:
        extra = dict(extra)
        probes = extra.pop("probes", None)
        chunk = extra.pop("chunk", None)
        cfg = funcs[func](os.path.join(out, name), **dict(
            extra, nt=steps, dtype=dtype))
        if probes:
            cfg["probes"] = probes
        cells.append({"name": name, "config": cfg, "shape": shape,
                      "steps": steps, "solver": kind, "chunk": chunk})
    spec = {"world": 2, "device": DEVICE, "out": out,
            "cells": json.loads(json.dumps(cells))}
    # the backend follows the device (multihost.maybe_initialize)
    print(f"phase 15: 2 ranks on {card}, backend "
          + ("nccl (NCCL_HOSTID per rank, socket transport on lo)"
             if DEVICE.startswith("cuda") else "gloo"))
    t0 = time.perf_counter()
    reports = _p15_launch(spec, timeout=480.0)
    print(f"phase 15 ranks done in {time.perf_counter() - t0:.1f} s")
    failures = []
    for cell, (name, _, shape, steps, dtype, kind, _) in zip(cells,
                                                             P15_CELLS):
        ref_dev = "cpu" if dtype == "float64" else DEVICE
        cfg = json.loads(json.dumps(cell["config"]))
        cfg["output"] = os.path.join(out, name + "-single")
        cfg["logs"] = cfg["output"]
        if name in P15_STENCIL_REFERENCE:
            cfg["parameters"]["disablePallas"] = True
        solver = _p15_solver(cfg, ref_dev, kind)
        ref = _p15_steps(solver, steps)
        want = _p15_fields(solver)
        solver.close()
        got = dict(np.load(os.path.join(out, f"{name}.npz")))

        def rel_diff(a, b):
            return {k: float(np.abs(a[k] - b[k]).max()
                             / max(np.abs(b[k]).max(), 1e-30)) for k in b}

        rel = rel_diff(got, want)
        tol = {k: 1e-4 for k in want}
        spread = None
        if name in P15_SPREAD:
            # the single rank against itself, its initial u one ulp up:
            # how far float32 rounding alone moves this cell's fields
            cfg["output"] = os.path.join(out, name + "-ulp")
            cfg["logs"] = cfg["output"]
            solver = _p15_solver(cfg, ref_dev, kind)
            u = solver.state["q"]["u"]
            solver.state["q"]["u"] = torch.nextafter(
                u, torch.full_like(u, math.inf))
            _p15_steps(solver, steps)
            spread = rel_diff(_p15_fields(solver), want)
            solver.close()
            tol = {k: max(1e-4, 3 * v) for k, v in spread.items()}
        absd = {k: float(np.abs(got[k] - want[k]).max()) for k in want}
        # rank 0's probe files against the single rank's
        for probe in cell["config"].get("probes", []):
            key = "probe " + probe["path"]
            a, b = (_probe_numbers(os.path.join(c["output"], probe["path"]))
                    for c in (cell["config"], cfg))
            if a.shape != b.shape:
                failures.append(f"{name}: {key} has {a.shape} numbers "
                                f"against {b.shape}")
                continue
            absd[key] = float(np.abs(a - b).max())
            rel[key] = absd[key] / max(float(np.abs(b).max()), 1e-30)
            tol[key] = 1e-4
        share, differ = _p15_iters(reports[0][name]["stats"], ref["stats"])
        ms = [r[name]["ms"] for r in reports]
        comm = reports[0][name]["comm"]
        timed = max(steps - 1, 1)
        per_step = {k: {"calls": v["calls"] / timed,
                        "bytes": v["bytes"] / timed}
                    for k, v in comm.items() if k != "gather"}
        launches = [r[name]["launches"] for r in reports]
        implied = [_p15_implied(*r[name]["sweeps"], r[name]["stats"])
                   for r in reports]
        fallbacks = [[int(s.get("fallback", 0)) for s in run["stats"]]
                     for run in (reports[0][name], ref)]
        rec = {"cell": name, "mesh": shape, "steps": steps, "dtype": dtype,
               "backend": reports[0][name]["backend"],
               "fdm_core": reports[0][name]["fdm_core"],
               "rank_devices": [r[name]["device"] for r in reports],
               "reference": ref_dev + (" (disablePallas)" if name in
                                       P15_STENCIL_REFERENCE else ""),
               "max_rel_diff": rel,
               "max_abs_diff": absd, "iters_equal_share": share,
               "iters_differ": differ[:10], "ms_per_step_ranks": ms,
               "ms_per_step_single": ref["ms"],
               "collectives_per_step_rank0": per_step,
               "rank_kernel_launches": launches,
               "rank_launches_implied": implied,
               "rank_mg_blocks": [r[name]["mg_levels"] for r in reports],
               "fallbacks": fallbacks, "ulp_spread": spread,
               "tolerance": tol,
               "p_iters": [int(s["p_iters"]) for s in ref["stats"]],
               "card": card}
        if cell["chunk"]:
            rec["chunk"] = _p15_chunk_record(name, cell["chunk"], reports,
                                             failures)
        print(json.dumps({"distributed": rec}))
        if DEVICE.startswith("cuda") and launches != implied:
            failures.append(f"{name}: the ranks launched {launches}, their "
                            f"stats imply {implied}")
        if fallbacks[0] != fallbacks[1]:
            failures.append(f"{name}: fallbacks {fallbacks[0]} against "
                            f"{fallbacks[1]}")
        if dtype == "float64":
            bad = {k: v for k, v in absd.items() if not v <= 1e-9}
            if bad or differ:
                failures.append(f"{name}: {bad} above 1e-9 or iterations "
                                f"differ at {differ[:5]}")
        else:
            bad = {k: v for k, v in rel.items() if not v <= tol[k]}
            if bad or share < 0.95:
                failures.append(f"{name}: {bad} above {tol} or iterations "
                                f"equal on {share:.2%} of steps")
    if failures:
        raise AssertionError("phase 15: " + "; ".join(failures))


#: the benchmark's configurations E and H are held at (benchmark/configs):
#: the sphere (160x130x130, 1963 points) and the cylinder (450^2, 314)
DELTA_SHAPES = ("sphere3d_re300", "cylinder2d_re200")


def _delta_case(name: str, dtype):
    """The benchmark configuration's delta engine, windows, random fields
    and forces on the card (numpy seed 7)."""
    import numpy as np
    import torch

    from petibm_tpu_torch.ibm.body import read_lagrangian_points
    from petibm_tpu_torch.ibm.interp import make_delta_op
    from petibm_tpu_torch.mesh import StaggeredMesh
    from petibm_tpu_torch.types import Field

    configs = os.path.join(REPO, "benchmark", "configs")
    with open(os.path.join(configs, f"{name}.json")) as fh:
        cfg = json.load(fh)
    mesh = StaggeredMesh(cfg)
    X = read_lagrangian_points(os.path.join(configs, cfg["body"]))
    op = make_delta_op(mesh, n_pts=X.shape[0], dtype=dtype, device=DEVICE)
    win = op.windows(torch.as_tensor(X, dtype=dtype, device=DEVICE))
    rng = np.random.default_rng(7)
    fields = [torch.as_tensor(rng.standard_normal(mesh.shape(Field(c))),
                              dtype=dtype, device=DEVICE)
              for c in range(mesh.dim)]
    f = torch.as_tensor(rng.standard_normal((X.shape[0], mesh.dim)),
                        dtype=dtype, device=DEVICE)
    return op, win, fields, f


def _window_cells(win: dict, shapes: list) -> int:
    """Distinct cells the windows touch, over the components: the cells E
    must read and H must read and write."""
    import torch

    total = 0
    for c, shape in enumerate(shapes):
        idx = win[c]["idx"].long()
        if len(shape) == 3:
            lin = ((idx[2][:, :, None, None] * shape[1]
                    + idx[1][:, None, :, None]) * shape[2]
                   + idx[0][:, None, None, :])
        else:
            lin = idx[1][:, :, None] * shape[1] + idx[0][:, None, :]
        total += int(torch.unique(lin).numel())
    return total


def phase16_delta(tmp: str) -> dict:
    """E and H of the factor delta engine (``ibm/cuda_delta.py``) at the
    benchmark's sphere and cylinder shapes, float32 (the benchmark's) and
    float64: each kernel against its plain twin on the card bit for bit
    (H as the step's fold, u + dt H f, in place), H twice bit-equal; then
    each timed (device median per call, ``_time_ms``) beside its bound
    (the window cells read, and for H written, once; the windows and
    forces read once), the twin and today's dense factor-row matmuls
    (``interpolate_rows`` / ``spread_rows`` + the add, ``library_ms``:
    the port no longer calls them undecomposed, held to the kernel to
    1e-5 relative in float32, 1e-12 in float64).  One ``{"delta": ...}``
    JSON line."""
    import torch

    from petibm_tpu_torch.ibm import cuda_delta

    dt = 0.005
    records = {}
    for name in DELTA_SHAPES:
        for dtype in (torch.float32, torch.float64):
            op, win, fields, f = _delta_case(name, dtype)
            label = f"{name} {str(dtype)[6:]}"
            size = fields[0].element_size()
            n_pts, dim = f.shape
            K = win[0]["idx"].shape[-1]
            cells = _window_cells(win, [x.shape for x in fields])
            windows = dim * dim * n_pts * K * (4 + size)
            tol = 1e-5 if dtype == torch.float32 else 1e-12

            # E: kernel, twin, library
            got = cuda_delta.interpolate(fields, win)
            want = cuda_delta.interpolate_ref(fields, win)
            lib = op.interpolate_rows(dict(zip("uvw", fields)), win)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{label} E: kernel != twin")
            lib_rel = _rel_err(lib, got)
            if not lib_rel <= tol:
                raise AssertionError(f"{label} E: library rel {lib_rel}")
            work = (cells * size + windows + n_pts * dim * size,
                    3 * dim * n_pts * K ** dim, dtype)
            rec_e = _time_delta(
                f"{label} E", lambda a: cuda_delta.interpolate(a, win),
                lambda a: cuda_delta.interpolate_ref(a, win),
                lambda a: op.interpolate_rows(dict(zip("uvw", a)), win),
                fields, work)
            rec_e["library_rel"] = lib_rel

            # H: u + dt H f in place, twice; the twin's; the library's
            runs = []
            for _ in range(2):
                out = [x.clone() for x in fields]
                cuda_delta.spread(f, win, out, dt)
                runs.append(out)
            twin = [x.clone() for x in fields]
            cuda_delta.spread_ref(f, win, twin, dt)
            alone = [torch.zeros_like(x) for x in fields]
            cuda_delta.spread(f, win, alone)
            lib = op.spread_rows(f, win)
            torch.cuda.synchronize()
            for a, b, t in zip(*runs, twin):
                if not (torch.equal(a, b) and torch.equal(a, t)):
                    raise AssertionError(f"{label} H: kernel runs or twin "
                                         "differ")
            lib_rel = max(_rel_err(lib[k], h) for k, h in zip("uvw", alone))
            if not lib_rel <= tol:
                raise AssertionError(f"{label} H: library rel {lib_rel}")
            scratch = [x.clone() for x in fields]
            work = (2 * cells * size + windows + n_pts * dim * size,
                    4 * dim * n_pts * K ** dim, dtype)

            def library(a):
                h = op.spread_rows(f, win)
                return [x + dt * h[k] for x, k in zip(a, "uvw")]

            rec_h = _time_delta(
                f"{label} H", lambda a: cuda_delta.spread(f, win, a, dt),
                lambda a: cuda_delta.spread_ref(f, win, a, dt), library,
                scratch, work)
            rec_h["library_rel"] = lib_rel
            records[label] = {"E": rec_e, "H": rec_h, "points": n_pts,
                              "window_cells": cells}
            del op, win, fields, f, runs, twin, alone, lib, scratch
            torch.cuda.empty_cache()
    print(json.dumps({"delta": records, "card": _smi()}))
    return records


def _time_delta(label: str, kernel, twin, library, arg, work) -> dict:
    """A delta kernel timed beside its bound, its twin and the dense
    factor-row matmuls it replaced, each on ``arg``."""
    ms = _time_ms(kernel, arg)[0]
    plain_ms = _time_ms(twin, arg, 20, batch=5, warm=3)[0]
    library_ms = _time_ms(library, arg, 40, batch=5, warm=3)[0]
    bound_ms, bound_by = _bound(*work)
    print(f"{label}: kernel {ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
          f"({bound_by}: {work[0] / 1e6:.2f} MB, {work[1] / 1e6:.2f} Mop), "
          f"share {bound_ms / ms:.3f}; twin {plain_ms * 1e3:.2f} us; "
          f"library (dense factor rows) {library_ms * 1e3:.2f} us "
          f"(device, median per call)")
    return {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "plain_ms": plain_ms, "library_ms": library_ms}


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
        counts_fft_bf16 = phase13_fft_bf16(tmp, tgv, mg_solvers)
        done(13)
        counts_chunked = phase14_chunked(tmp, _smi())
        done(14)
        phase15_distributed(tmp, _smi())
        done(15)
        phase16_delta(tmp)
        done(16)
    # each main path's launches, counted from 0 just before it ran
    runs = ([counts_2d, counts_sphere, counts_tgv] + counts_mg
            + counts_coupled + counts_moving + counts_windowed
            + counts_fft_bf16 + counts_chunked)
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
    if len(sys.argv) > 1 and sys.argv[1] == "--phase15-rank":
        phase15_rank(sys.argv[2], int(sys.argv[3]))
        sys.exit(0)
    sys.exit(main())
