"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order (any failure raises and the script exits non-zero):

0. require CUDA; print the torch/CUDA versions and the card's name and
   power limit;
1. build the hand-written kernels from ``petibm_tpu_torch/csrc``;
2. hold each kernel against its plain PyTorch twin on the card at the
   shapes of the main path, and time both;
3. run the 2D decoupled-IBPM cylinder (Re=200, 450^2 stretched grid,
   157 body points, float32; the ``bench.py`` configuration) through
   ``DecoupledIBPMSolver.run()`` and check that every kernel of the path
   was launched, as often as the solver stats say;
4. A/B the same steps with the kernels on and off (``disablePallas``).

The line before the last is the per-kernel JSON record; the last line is
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


def _circle(path: str, n: int) -> str:
    """A body file: n points on the circle of diameter 1 at the origin."""
    with open(path, "w") as fh:
        fh.write(f"{n}\n")
        for k in range(n):
            th = 2 * math.pi * k / n
            fh.write(f"{0.5 * math.cos(th):10.8e}\t"
                     f"{0.5 * math.sin(th):10.8e}\n")
    return path


def _config(tmp: str, axes: list, nu: float, dt: float, npts: int,
            **params) -> dict:
    """A decoupled-IBPM cylinder in a uniform stream, built as a dict (the
    card need not have pyyaml)."""
    os.makedirs(tmp)
    faces = {"xMinus": ("DIRICHLET", 1.0, 0.0), "xPlus": ("CONVECTIVE", 1.0, 1.0),
             "yMinus": ("DIRICHLET", 1.0, 0.0), "yPlus": ("DIRICHLET", 1.0, 0.0)}
    solver = {"type": "CPU", "atol": 1e-6, "rtol": 1e-6, "max_it": 1000}
    parameters = {
        "dt": dt, "nt": 10, "nsave": 10 ** 6, "nrestart": 10 ** 6,
        "dtype": "float32", "divergence": "abort",
        "convection": "ADAMS_BASHFORTH_2", "diffusion": "CRANK_NICOLSON",
        "velocitySolver": dict(solver), "poissonSolver": dict(solver),
        "forcesSolver": dict(solver)}
    parameters.update(params)
    return {
        "directory": tmp, "output": os.path.join(tmp, "output"),
        "logs": os.path.join(tmp, "logs"),
        "mesh": [{"direction": d, "start": axes[0], "subDomains": axes[1]}
                 for d in ("x", "y")],
        "flow": {"nu": nu, "initialVelocity": [1.0, 0.0],
                 "boundaryConditions": [
                     {"location": loc, "u": [t, u], "v": [t, v]}
                     for loc, (t, u, v) in faces.items()]},
        "parameters": parameters,
        "bodies": [{"type": "points",
                    "file": _circle(os.path.join(tmp, "circle.body"), npts)}],
    }


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
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase1_build() -> None:
    from petibm_tpu_torch import _kernels

    path, seconds = _kernels.build("poisson_separable")
    print(f"built {path.name} in {seconds:.2f} s"
          + (" (already built)" if seconds == 0.0 else ""))


def _flagship_level(dtype):
    """Level-0 Poisson factors of the 450^2 flagship grid."""
    import tempfile

    import torch

    from petibm_tpu_torch.linalg.mg import poisson_level0
    from petibm_tpu_torch.mesh import StaggeredMesh

    with tempfile.TemporaryDirectory() as tmp:
        cfg = flagship_config(os.path.join(tmp, "case"))
        mesh = StaggeredMesh(cfg)
    return poisson_level0(mesh.dxp, mesh.periodic, dtype=dtype,
                          device=torch.device("cuda"),
                          scale=cfg["parameters"]["dt"])


def phase2_kernels() -> dict:
    """K1 against its plain twin on the card; returns the flagship (450^2
    f32) record."""
    import numpy as np
    import torch

    from petibm_tpu_torch.linalg.mg import poisson_level0
    from petibm_tpu_torch.operators.cuda_stencil import (
        poisson_apply_separable, poisson_apply_separable_ref)

    cuda = torch.device("cuda")
    widths3 = [np.geomspace(1.0, 1.7, n) * 0.02 for n in (96, 80, 64)]
    cases = [("450x450", torch.float32, _flagship_level(torch.float32), 1e-6),
             ("450x450", torch.float64, _flagship_level(torch.float64), 1e-13),
             ("96x80x64", torch.float32,
              poisson_level0(widths3, [False] * 3, dtype=torch.float32,
                             device=cuda, scale=0.0025), 1e-6),
             ("96x80x64", torch.float64,
              poisson_level0(widths3, [False] * 3, dtype=torch.float64,
                             device=cuda, scale=0.0025), 1e-13)]
    gen = torch.Generator(device=cuda).manual_seed(0)
    record = None
    for name, dtype, level, tol in cases:
        phi = torch.randn(level.shape, generator=gen, device=cuda, dtype=dtype)
        got = poisson_apply_separable(phi, level)
        want = poisson_apply_separable_ref(phi, level)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        ms, host_ms = _time_ms(
            lambda x: poisson_apply_separable(x, level), phi)
        plain_ms, plain_host_ms = _time_ms(
            lambda x: poisson_apply_separable_ref(x, level), phi)
        print(f"K1 {name} {str(dtype)[6:]}: max|kernel-twin| {err:.3e} "
              f"(rel {rel:.3e}, tol {tol:g}); per apply (median), device: "
              f"kernel {ms * 1e3:.2f} us, twin {plain_ms * 1e3:.2f} us; "
              f"host wall: kernel {host_ms * 1e3:.2f} us, "
              f"twin {plain_host_ms * 1e3:.2f} us")
        if not rel <= tol:
            raise AssertionError(f"K1 {name} {dtype}: rel error {rel} > {tol}")
        if record is None:
            record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return record


def _rel_err(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def phase3_slice(tmp: str):
    """The 450^2 flagship through run(); returns (solver, K1 launches)."""
    import torch

    from petibm_tpu_torch.operators.cuda_stencil import poisson_apply_separable
    from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver

    t0 = time.perf_counter()
    solver = DecoupledIBPMSolver(flagship_config(os.path.join(tmp, "run"),
                                                 nt=100), device="cuda")
    torch.cuda.synchronize()
    print(f"setup {time.perf_counter() - t0:.2f} s: {solver.mesh.info()}"
          .replace("\n", "; "))
    print(f"bodies: {solver.bodies.n_pts} points; dtype {solver.dtype}")

    # the main path: steps 1-100, then 101-300 timed (the run extended)
    poisson_apply_separable.launches = 0
    solver.run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.nt = 300
    solver.run()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = poisson_apply_separable.launches
    solver.close()

    hist = solver.stats_history
    if len(hist) != 300:
        raise AssertionError(f"ran {len(hist)} steps, expected 300")
    bad = [s["ite"] for s in hist
           if not (s["v_ok"] and s["p_ok"] and s["f_ok"])]
    if bad:
        raise AssertionError(f"solver not converged at steps {bad[:10]}")
    expected = sum(2 + s["p_iters"] for s in hist)
    print(f"K1 launches {launches}, sum(2 + p_iters) {expected}")
    if launches != expected:
        raise AssertionError(f"K1 launched {launches} times, the pressure "
                             f"solves evaluated {expected} residuals")
    st = solver.state
    fields = {"u": st["q"]["u"], "v": st["q"]["v"], "p": st["p"],
              "f": st["f"]}
    nx, ny = (sum(sub["cells"] for sub in ax["subDomains"])
              for ax in solver.config["mesh"])
    with open(solver.config["bodies"][0]["file"]) as fh:
        npts = int(fh.readline())
    shapes = {"u": (ny, nx - 1), "v": (ny - 1, nx), "p": (ny, nx),
              "f": (npts, 2)}
    for name, arr in fields.items():
        if tuple(arr.shape) != shapes[name]:
            raise AssertionError(f"{name} shape {tuple(arr.shape)}")
        if not bool(torch.isfinite(arr).all()):
            raise AssertionError(f"{name} has non-finite values")
    fx, fy = solver.bodies.avg_forces(st["f"].cpu().numpy())[0]
    last = hist[-1]
    print(f"{elapsed / 200 * 1e3:.3f} ms/step over steps 101-300 "
          f"(synchronised); last step v/p/f iters {last['v_iters']}/"
          f"{last['p_iters']}/{last['f_iters']}; t = {solver.t:.4f}: "
          f"Cd {2 * fx:.5f}, Cl {2 * fy:.5f}")
    return solver, launches


def phase4_ab(tmp: str, solver) -> None:
    """20 steps from the developed state with K1 and with the stencil
    closure (disablePallas); then a small case on the card against the
    plain-PyTorch CPU path."""
    from petibm_tpu_torch.convert import state_from_numpy, state_to_numpy
    from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver

    # In float64 every field must agree.  In float32 the pressure is only
    # determined to the solve's tolerance: its low modes amplify the
    # operators' different roundings of the residual by the condition
    # number, so float32 holds the velocity and the forces and reports p.
    start = state_to_numpy(solver.state)
    for dtype, checked in (("float64", "uvpf"), ("float32", "uvf")):
        runs = {}
        for name, disable in (("K1", False), ("stencil", True)):
            s = DecoupledIBPMSolver(flagship_config(
                os.path.join(tmp, f"ab_{dtype}_{name}"), nt=20, dtype=dtype,
                disablePallas=disable), device="cuda")
            s.state = state_from_numpy(start, "cuda", s.dtype)
            s.run()
            s.close()
            runs[name] = s
            print(f"{dtype} {name}: v/p/f iters " + " ".join(
                f"{h['v_iters']}/{h['p_iters']}/{h['f_iters']}"
                for h in s.stats_history))
        a, b = runs["K1"].state, runs["stencil"].state
        for key, x, y in (("u", a["q"]["u"], b["q"]["u"]),
                          ("v", a["q"]["v"], b["q"]["v"]),
                          ("p", a["p"], b["p"]), ("f", a["f"], b["f"])):
            rel = _rel_err(x, y)
            held = key in checked
            print(f"A/B {dtype} {key}: max rel diff {rel:.3e}"
                  + (" (tol 1e-5)" if held else " (reported)"))
            if held and not rel <= 1e-5:
                raise AssertionError(
                    f"K1 / stencil A/B differ in {key} ({dtype}): {rel}")

    # small input: the CUDA path against the plain-PyTorch CPU path, f64
    small = {}
    for dev in ("cuda", "cpu"):
        cfg = small_config(os.path.join(tmp, f"small_{dev}"), nt=20,
                           dtype="float64")
        s = DecoupledIBPMSolver(cfg, device=dev)
        s.run()
        s.close()
        small[dev] = s
    for key in ("p", "f"):
        rel = _rel_err(small["cuda"].state[key].cpu(), small["cpu"].state[key])
        print(f"32^2 f64 cuda vs cpu {key}: max rel diff {rel:.3e} (tol 1e-9)")
        if not rel <= 1e-9:
            raise AssertionError(f"cuda and cpu paths differ in {key}: {rel}")
    streams = {dev: [{k: v for k, v in h.items()
                      if k.endswith(("_iters", "_ok"))}
                     for h in s.stats_history] for dev, s in small.items()}
    if streams["cuda"] != streams["cpu"]:
        raise AssertionError("cuda and cpu iteration counts or ok flags differ")


def main() -> int:
    import tempfile

    device = phase0_device()
    phase1_build()
    k1 = phase2_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        solver, launches = phase3_slice(tmp)
        phase4_ab(tmp, solver)
    print(json.dumps({"kernels": [dict(
        name="poisson_apply_separable", route="cuda",
        source="petibm_tpu_torch/csrc/poisson_separable.cu",
        replaces="petibm_tpu/operators/pallas_stencil.py:117",
        launches=launches, **k1)]}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
