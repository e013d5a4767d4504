"""Per-phase time breakdown of the time step.

Counterpart of ``petibm_tpu/utils/profiling.py``.  The reference delimits
every phase of the step with PETSc log stages and dumps -log_view tables
at each save (navierstokes.cpp:99-199, io.cpp:274 writePetscLog).  The
JAX package's step is one fused XLA program, so it times prefix programs
and takes differences.  The port's step is the phases of
``solver._profile_phases()`` chained (``chain_phases``), and a traced
step stamps the card's clock at its start and after each phase
(``utils/stamps.py``), without a synchronise.  ``profile_stages`` runs the
production step eagerly from a fixed developed snapshot with its stamps
on, synchronised before each step; a phase's time is the span between its
stamps on the device's stream (the host clock on the CPU), so a
host-bound phase counts its launch gaps, as a user's step does; each
phase's median over ``steps`` trials is reported in ms.

The result keys are the JAX package's: the phases, ``_total`` (here the
sum over the phases) and ``_fused`` (the median of the step's span from
its first stamp to its last).
"""

from __future__ import annotations

import os
import statistics

import numpy as np
import torch

from . import stamps


def chain_phases(phases: list, state: dict) -> dict:
    """One step as the chained phases; returns the last context (its
    "state" the new state).  A traced step (``stamps.use``) stamps its
    start and the end of each phase."""
    ctx = {"state": state}
    stamps.stamp(0)
    for i, (_, fn) in enumerate(phases):
        ctx = fn(ctx)
        stamps.stamp(i + 1)
    return ctx


def profile_stages(solver, steps: int = 10, warmup: int = 3,
                   path: str | None = None) -> dict:
    """The phase breakdown of one step: {phase: ms}, "_total" (the sum
    over the phases) and "_fused" (the step's stamped span), the medians
    over ``max(3, steps)`` stamped production steps from the state
    ``warmup`` production steps past ``solver.state`` (which stays as it
    was).  Writes the stage table to ``path``."""
    names = [name for name, _ in solver._profile_phases()]
    device = solver.device
    state = solver.state
    for _ in range(max(1, warmup)):
        state, _ = solver._step_fn(state)

    layout = stamps.Layout(names)
    clock = stamps.Clock.calibrate(device)
    rows = []
    for _ in range(max(3, steps)):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        st = stamps.Stamps.one_row(layout, clock, device)
        with stamps.use(st):
            solver._step_fn(state)
            st.end()
        rows.append(st.rows)
    ns = torch.cat(rows).cpu().numpy()[:, :len(layout.names)]
    spans = np.diff(ns, axis=1) / 1e6
    result = {name: statistics.median(spans[:, i].tolist())
              for i, name in enumerate(names)}
    result["_total"] = sum(result.values())
    result["_fused"] = statistics.median(
        ((ns[:, -1] - ns[:, 0]) / 1e6).tolist())
    if path:
        _write_table(path, result, steps)
    return result


def _write_table(path: str, result: dict, steps: int) -> None:
    """The JAX package's table layout."""
    phases = {k: v for k, v in result.items() if not k.startswith("_")}
    total = max(result.get("_total", 0.0), 1e-12)
    lines = [
        f"stage breakdown (medians over {max(3, steps)} trials; each "
        "phase between the step's device stamps, synchronised before "
        "each step)",
        f"{'stage':>16s} {'ms/step':>10s} {'%':>6s}",
    ]
    for name, ms in phases.items():
        lines.append(f"{name:>16s} {ms:10.4f} {100 * ms / total:6.1f}")
    lines.append(f"{'total (phases)':>16s} {result['_total']:10.4f}")
    lines.append(f"{'fused step':>16s} {result['_fused']:10.4f}"
                 "   (production step, first stamp to last)")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
