"""Per-phase time breakdown of the time step.

Counterpart of ``petibm_tpu/utils/profiling.py``.  The reference delimits
every phase of the step with PETSc log stages and dumps -log_view tables
at each save (navierstokes.cpp:99-199, io.cpp:274 writePetscLog).  The
JAX package's step is one fused XLA program, so it times prefix programs
and takes differences.  The port's step is the phases of
``solver._profile_phases()`` chained (``chain_phases``), run eagerly, so
each phase is timed alone: from a fixed developed snapshot, the phases
are chained, the device
synchronised before each phase and CUDA events recorded around it (the
host clock on the CPU); each phase's median over ``steps`` trials is
reported in ms.  A phase's time is its span on the device's stream, so a
host-bound phase counts its launch gaps, as a user's step does.

The result keys are the JAX package's: the phases, ``_total`` (here the
sum over the phases) and ``_fused`` (the median of one synchronised
production step from the same snapshot).

``trace()`` records a ``torch.profiler`` trace of the production step.
"""

from __future__ import annotations

import os
import statistics
import time

import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Timer:
    """Elapsed ms of a region: CUDA events on a card, the host clock on
    the CPU; the device is synchronised before the region starts."""

    def __init__(self, device: torch.device):
        self.device = device

    def __enter__(self):
        _sync(self.device)
        if self.device.type == "cuda":
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            self._events[1].record()
            self._events[1].synchronize()
            self.ms = self._events[0].elapsed_time(self._events[1])
        else:
            self.ms = (time.perf_counter() - self._t0) * 1e3
        return False


def chain_phases(phases: list, state: dict) -> dict:
    """One step as the chained phases; returns the last context (its
    "state" the new state)."""
    ctx = {"state": state}
    for _, fn in phases:
        ctx = fn(ctx)
    return ctx


def profile_stages(solver, steps: int = 10, warmup: int = 3,
                   path: str | None = None) -> dict:
    """The phase breakdown of one step: {phase: ms}, "_total" (the sum
    over the phases) and "_fused" (one synchronised production step), the
    medians over ``max(3, steps)`` trials from the state ``warmup``
    production steps past ``solver.state`` (which stays as it was).
    Writes the stage table to ``path``."""
    phases = solver._profile_phases()
    device = solver.device
    state = solver.state
    for _ in range(max(1, warmup)):
        state, _ = solver._step_fn(state)

    trials = {name: [] for name, _ in phases}
    fused = []
    for _ in range(max(3, steps)):
        ctx = {"state": state}
        for name, fn in phases:
            with _Timer(device) as timer:
                ctx = fn(ctx)
            trials[name].append(timer.ms)
        with _Timer(device) as timer:
            solver._step_fn(state)
        fused.append(timer.ms)

    result = {name: statistics.median(ms) for name, ms in trials.items()}
    result["_total"] = sum(result.values())
    result["_fused"] = statistics.median(fused)
    if path:
        _write_table(path, result, steps)
    return result


def _write_table(path: str, result: dict, steps: int) -> None:
    """The JAX package's table layout."""
    phases = {k: v for k, v in result.items() if not k.startswith("_")}
    total = max(result.get("_total", 0.0), 1e-12)
    lines = [
        f"stage breakdown (medians over {max(3, steps)} trials; each "
        "phase timed alone, synchronised before it)",
        f"{'stage':>16s} {'ms/step':>10s} {'%':>6s}",
    ]
    for name, ms in phases.items():
        lines.append(f"{name:>16s} {ms:10.4f} {100 * ms / total:6.1f}")
    lines.append(f"{'total (phases)':>16s} {result['_total']:10.4f}")
    lines.append(f"{'fused step':>16s} {result['_fused']:10.4f}"
                 "   (production step, synchronised)")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def trace(solver, out_dir: str, steps: int = 20) -> str:
    """A ``torch.profiler`` trace of ``steps`` production steps from
    ``solver.state`` (which stays as it was), written as a Chrome trace
    into ``out_dir``; returns its path."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if solver.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    state, _ = solver._step_fn(solver.state)  # first launches outside
    _sync(solver.device)
    with profile(activities=activities) as prof:
        for _ in range(steps):
            state, _ = solver._step_fn(state)
        _sync(solver.device)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path
