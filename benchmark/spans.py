"""The port's own spans and device stamps, read for the per-layer
metrics of the chunk, the solves and the operators.

``of(run)`` runs once a traced cell, after the readers that come before
it (the new metrics sit last in ``BENCHMARK.json``), and is cached on
``run``: it switches the solver's tracing on (``solver.trace_spans``: the
chunk's stamped graph captured beside the plain one), runs the larger of
``MIN_CHUNKS`` chunks and ``MIN_SECONDS`` of chunks outside the profiler,
reads the solver's store (``solver.timers``: host spans on
``perf_counter_ns``, each chunk's device stamps) and switches tracing
off, so the plain graph replays again.  It is None off the card, and
where the program has no ``trace_spans`` (a version before the spans).

A traced step's stamps (``petibm_tpu_torch/utils/stamps.py``): its
start, the end of each phase of ``_profile_phases``, its end after the
write-back and the stats row.  Within a chunk, step i's span from start
to end and the gap to step i + 1's start, and the turnaround from a
chunk's last end to the next chunk's first start, add up to the chunk's
period on the card's clock with nothing left over.

The span run follows the harness's profiler in the same process, and
the profiler leaves CUPTI attached: a graph of tens of thousands of
nodes (the MG cell's) then launches far slower and the card waits
inside it, so no metric of the span run lists that cell.
"""

from __future__ import annotations

import statistics
import time

import numpy as np

#: the span run: at least this many chunks, and at least this long
MIN_CHUNKS = 20
MIN_SECONDS = 3.0
#: the phases whose spans ``operators_ms`` sums: the step's stencils,
#: convection, spreading and interpolation, boundary updates
OPERATOR_PHASES = ("moveIB", "rhsVelocity", "rhsForces", "applyNoSlip",
                   "rhsPoisson", "update")


def of(run):
    """The cell's span run, made once (None off the card or where the
    program has no spans)."""
    if not hasattr(run, "_spans"):
        solver = run.solver
        ok = solver.device.type == "cuda" and hasattr(solver, "trace_spans")
        run._spans = collect(solver, run.cell.k) if ok else None
    return run._spans


def collect(solver, k: int) -> "SpanRun":
    """Tracing on, chunks of ``k`` steps until both ``MIN_CHUNKS`` and
    ``MIN_SECONDS`` are reached, the store read, tracing off."""
    solver.trace_spans(True)
    try:
        t0 = time.perf_counter()
        chunks = 0
        while chunks < MIN_CHUNKS or time.perf_counter() - t0 < MIN_SECONDS:
            solver.nt += k
            solver.run()
            chunks += 1
    finally:
        solver.trace_spans(False)
    return SpanRun(solver.timers, k)


class SpanRun:
    """What one span run kept: the chunks' stamps (``stamps``: chunk,
    step, column, in ns on the card's clock from the clock's base) and
    the host spans."""

    def __init__(self, store, k: int):
        self.k = k
        self.spans = store.spans()
        blocks = [b for b in store.stamp_blocks() if len(b.values()) == k]
        if not blocks:
            raise RuntimeError("the span run kept no chunk's stamps")
        self.names = list(blocks[0].names)
        self.phases = self.names[1:-1]
        self.stamps = np.stack([b.values() for b in blocks])[
            :, :, :len(self.names)]
        self.ite0 = [b.ite0 for b in blocks]
        self.chunk_spans = [s for s in self.spans if s.name == "chunk"]

    def phase_ms(self, name: str) -> np.ndarray:
        """Every step's span of phase ``name``, in ms."""
        i = self.names.index(name)
        return (self.stamps[:, :, i] - self.stamps[:, :, i - 1]).ravel() / 1e6

    def phase_median_ms(self, name: str) -> float | None:
        return (float(np.median(self.phase_ms(name)))
                if name in self.phases else None)

    def operators_ms(self) -> float | None:
        names = [p for p in OPERATOR_PHASES if p in self.phases]
        if not names:
            return None
        return float(np.median(sum(self.phase_ms(p) for p in names)))

    def replay_gaps_us(self) -> np.ndarray:
        """The device time from a step's end to the next step's start,
        within each chunk, in us."""
        gaps = self.stamps[:, 1:, 0] - self.stamps[:, :-1, -1]
        return gaps.ravel() / 1e3

    def pairs(self) -> list:
        """The indices of consecutive chunks (no rerun between)."""
        return [c for c in range(len(self.ite0) - 1)
                if self.ite0[c + 1] == self.ite0[c] + self.k]

    def turnarounds_ms(self) -> np.ndarray:
        """Each chunk boundary's device time from the chunk's last end
        stamp to the next chunk's first start stamp, in ms."""
        return np.array([self.stamps[c + 1, 0, 0] - self.stamps[c, -1, -1]
                         for c in self.pairs()]) / 1e6

    def allocs_per_chunk(self) -> float | None:
        """The driver allocations a chunk, the mean over the chunks."""
        vals = [s.counts["device_allocs"] for s in self.chunk_spans
                if "device_allocs" in s.counts]
        return statistics.fmean(vals) if vals else None
