"""Cells of ``chip_smoke.py`` and the stencil kernels K1, K2 and K3 on
two checkouts of the repository in turns on one card: ms per step,
device ms per step, K1's device time per step and the iteration counts
of each cell, and the device time of each kernel at its main shapes.

Run on a machine with a CUDA card, from the repository root, with the
other checkout unpacked in a directory (for example ``git archive`` of
the parent commit into ``parent_check/``):

    python3 scripts/ab_torch_cells.py --parent parent_check
    python3 scripts/ab_torch_cells.py --parent parent_check \
        --cells sphere_fdm,sphere_mg

Cells (``--cells``, all by default): the 256^3 TGV with the FDM pressure
solve (``tgv_fdm``, phase 6) and with the multigrid-preconditioned CG
one (``tgv_mg``, phase 8), the 160x130x130 sphere likewise
(``sphere_fdm``, phase 5; ``sphere_mg``, phase 8), and the 450^2
flagship likewise (``flagship_fdm``, phase 3; ``flagship_mg``, phase 8:
K1's 2D path 2 + p_iters times a step, or twice a V-cycle).  Each run is a
process of its own that imports ``chip_smoke`` and ``petibm_tpu_torch``
from its checkout (so each builds and runs its own kernels), in the
order parent, change, change, parent.  A run first times K1 (the
flagship's and the sphere's pressure), K2a (the sphere's and the TGV's
u), K2b (the sphere's and the TGV's pressure) and K3 (the sphere's and
the TGV's three components: one launch, or the sum of a launch per
component where the checkout's ``convection3d_apply`` takes one) through
the wrappers in float32 (``chip_smoke._time_ms``: median device µs an
apply) and hashes K1's and K2's results (the same seeded inputs in every
run: their bits must not differ between the checkouts); then
runs each cell for its steps (``--steps``), times the steps after the
first (host clock, synchronised), then profiles ``--profile`` more steps
with torch.profiler (device ms per step: the device-side events only;
K1's device µs per step: its kernels' events, any design), and checks that every solve converged and, on the TGV, that the kinetic
energy did not grow over the run.  Prints the card's name and power
limit first, a JSON line per run, and the medians of each checkout's
two runs (the MG-CG cells also with device ms per V-cycle: their device
time follows the profile window's p_iters).
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: cell: (case, extra parameters, steps)
CELLS = {"tgv_fdm": ("tgv", {}, 20), "tgv_mg": ("tgv", {"fdm": False}, 10),
         "sphere_fdm": ("sphere", {}, 30),
         "sphere_mg": ("sphere", {"fdm": False}, 10),
         "flagship_fdm": ("flagship", {}, 30),
         "flagship_mg": ("flagship", {"fdm": False}, 10)}
#: parts of the names of K1's kernels in a profile: the 2D row march, the
#: z march of its Body, the one-thread-a-cell kernel
K1_KERNELS = ("rowmarch", "SeparableBody", "poisson_apply_separable_kernel")


def _energy(q: dict) -> float:
    return 0.5 * sum(float(a.double().pow(2).mean()) for a in q.values())


def _solver(tmp: str, cell: str):
    import chip_smoke
    from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver
    from petibm_tpu_torch.solvers.navierstokes import NavierStokesSolver

    case, params, _ = CELLS[cell]
    if case in ("sphere", "flagship"):
        make = getattr(chip_smoke, f"{case}_config")
        return DecoupledIBPMSolver(make(os.path.join(tmp, cell), nt=1,
                                        **params), device="cuda")
    solver = NavierStokesSolver(chip_smoke.tgv3d_config(
        os.path.join(tmp, cell), nt=1, **params), device="cuda")
    chip_smoke.tgv3d_initial_state(solver)
    return solver


def _cell(tmp: str, cell: str, nsteps: int, profile_steps: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    solver = _solver(tmp, cell)
    energies = [_energy(solver.state["q"])]
    solver.run()
    energies.append(_energy(solver.state["q"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.nt = nsteps
    solver.run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / (nsteps - 1)
    energies.append(_energy(solver.state["q"]))
    solver.nt += profile_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solver.run()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    k1_us = sum(e.self_device_time_total for e in events
                if any(k in e.key for k in K1_KERNELS))
    energies.append(_energy(solver.state["q"]))
    solver.close()
    hist = solver.stats_history
    if not all(v for s in hist for k, v in s.items() if k.endswith("_ok")):
        raise AssertionError(f"{cell}: a solve did not converge")
    window = [s["p_iters"] for s in hist[-profile_steps:]]
    device_ms = device_us / profile_steps / 1e3
    rec = {"ms_step": wall * 1e3, "device_ms_step": device_ms,
           "k1_device_us_step": k1_us / profile_steps,
           "window_p_iters": window,
           # one V-cycle per CG iteration and one more (MG-CG only)
           "device_ms_vcycle": device_ms / (statistics.mean(window) + 1),
           "v_iters": [s["v_iters"] for s in hist],
           "p_iters": [s["p_iters"] for s in hist]}
    if CELLS[cell][0] == "tgv":
        rec["energy"] = energies
        rec["energy_grew"] = any(b > a for a, b in zip(energies,
                                                       energies[1:]))
    return rec


def _k3(cs, conv):
    """K3's three components of the extended arrays: one launch, or one
    launch a component (a checkout whose ``convection3d_apply`` takes the
    component)."""
    if len(inspect.signature(cs.convection3d_apply).parameters) == 3:
        return lambda e: [cs.convection3d_apply(e, c, conv.inv_dl[c])
                          for c in range(3)]
    return lambda e: cs.convection3d_apply(e, conv.inv_dl)


def _kernels_us(tmp: str) -> tuple:
    """Median device µs an apply of K1, K2a, K2b and K3 through the
    wrappers, float32, at the cells' shapes; and a hash of K1's and K2's
    results."""
    import torch

    import chip_smoke
    from petibm_tpu_torch.linalg.mg import poisson_level0
    from petibm_tpu_torch.operators import cuda_stencil as cs

    gen = torch.Generator(device="cuda").manual_seed(0)
    out, bits = {}, {}
    for name, make in (("flagship", chip_smoke.flagship_config),
                       ("sphere", chip_smoke.sphere_config),
                       ("tgv256", chip_smoke.tgv3d_config)):
        cfg = make(os.path.join(tmp, f"k_{name}"))
        mesh, bcs = chip_smoke._mesh_and_bcs(cfg)
        dt = cfg["parameters"]["dt"]
        level = poisson_level0(mesh.dxp, mesh.periodic, dtype=torch.float32,
                               device="cuda", scale=dt)
        phi = torch.randn(tuple(level.shape), generator=gen, device="cuda")
        applies = {}
        if name != "tgv256":
            applies["K1"] = lambda x: cs.poisson_apply_separable(x, level)
        if name != "flagship":
            applies["K2b"] = cs.make_cuda_poisson_zblocked(level)
            A = cs.make_cuda_momentum(mesh, bcs, dt, 0.5 * cfg["flow"]["nu"],
                                      dtype=torch.float32, device="cuda")
            u = torch.randn(tuple(mesh.shape(0)), generator=gen,
                            device="cuda")

            def k2a(x):
                return cs.zblocked_helmholtz_apply(x, A.vecs["u"], A.periodic)

            out[f"K2a {name} u"] = chip_smoke._time_ms(k2a, u)[0] * 1e3
            bits[f"K2a {name} u"] = _hash(k2a(u))
            conv = cs.make_cuda_convection(mesh, bcs, dtype=torch.float32,
                                           device="cuda")
            q = {k: torch.randn(tuple(mesh.shape(c)), generator=gen,
                                device="cuda") for c, k in enumerate("uvw")}
            state = bcs.init_state(q)
            ext = [bcs.extend(q[k], c, state) for c, k in enumerate("uvw")]
            out[f"K3 {name} u/v/w"] = chip_smoke._time_ms(_k3(cs, conv),
                                                          ext)[0] * 1e3
        for key, fn in applies.items():
            out[f"{key} {name} p"] = chip_smoke._time_ms(fn, phi)[0] * 1e3
            bits[f"{key} {name} p"] = _hash(fn(phi))
    return out, bits


def _hash(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def child(root: str, args) -> None:
    sys.path.insert(0, root)
    with tempfile.TemporaryDirectory() as tmp:
        us, bits = _kernels_us(tmp)
        rec = {"root": root, "kernels_us": us, "kernels_bits": bits}
        for cell in args.cells:
            rec[cell] = _cell(tmp, cell, args.steps.get(cell,
                                                        CELLS[cell][2]),
                              args.profile)
    print(json.dumps(rec), flush=True)


def _steps(text: str) -> dict:
    return {k: int(v) for k, v in (item.split("=") for item in
                                   text.split(",") if item)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other checkout's directory")
    ap.add_argument("--cells", default=",".join(CELLS),
                    help="comma-separated cells, of " + ", ".join(CELLS))
    ap.add_argument("--steps", default="",
                    help="steps of a cell, as cell=n,... (default "
                    + ", ".join(f"{c}={v[2]}" for c, v in CELLS.items())
                    + ")")
    ap.add_argument("--profile", type=int, default=5)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.cells = [c for c in args.cells.split(",") if c]
    unknown = [c for c in args.cells if c not in CELLS]
    if unknown:
        ap.error(f"unknown cells {unknown}")
    args.steps = _steps(args.steps)
    if args.child:
        child(args.child, args)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    roots = {"parent": os.path.abspath(args.parent), "change": REPO}
    runs = {"parent": [], "change": []}
    for label in ("parent", "change", "change", "parent"):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             roots[label], "--cells", ",".join(args.cells), "--steps",
             ",".join(f"{c}={n}" for c, n in args.steps.items()),
             "--profile", str(args.profile)],
            capture_output=True, text=True, cwd=roots[label])
        if out.returncode != 0:
            raise RuntimeError(f"{label} run failed:\n{out.stderr[-4000:]}")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        runs[label].append(rec)
        print(label, json.dumps(rec), flush=True)
    changed = [k for k in runs["parent"][0]["kernels_bits"]
               if len({r["kernels_bits"][k] for recs in runs.values()
                       for r in recs}) != 1]
    print(f"K1 and K2 results over the four runs: bits differ in "
          f"{changed or 'none'}", flush=True)
    for label, recs in runs.items():
        us = {k: [r["kernels_us"][k] for r in recs]
              for k in recs[0]["kernels_us"]}
        print(f"{label} kernels, device us an apply, median (runs): "
              + "; ".join(f"{k} {statistics.median(t):.2f} ("
                          + ", ".join(f"{x:.2f}" for x in t) + ")"
                          for k, t in us.items()), flush=True)
        for cell in args.cells:
            wall = [r[cell]["ms_step"] for r in recs]
            device = [r[cell]["device_ms_step"] for r in recs]
            vcycle = [round(r[cell]["device_ms_vcycle"], 3) for r in recs]
            window = [r[cell]["window_p_iters"] for r in recs]
            k1 = [r[cell]["k1_device_us_step"] for r in recs]
            print(f"{label} {cell}: ms/step {statistics.median(wall):.3f} "
                  f"(runs {wall[0]:.3f}, {wall[1]:.3f}), device ms/step "
                  f"{statistics.median(device):.3f} (runs {device[0]:.3f}, "
                  f"{device[1]:.3f}), K1 device us/step (runs {k1[0]:.2f}, "
                  f"{k1[1]:.2f}); v_iters {recs[0][cell]['v_iters']}, "
                  f"p_iters {recs[0][cell]['p_iters']}"
                  + ("" if not cell.endswith("_mg") else
                     f"; profile window p_iters {window}, device ms per "
                     f"V-cycle {vcycle}"), flush=True)
    grew = [label for label, recs in runs.items()
            if any(r[c].get("energy_grew") for r in recs for c in args.cells)]
    return 1 if grew or changed else 0


if __name__ == "__main__":
    sys.exit(main())
