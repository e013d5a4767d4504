"""Stage timers replacing PETSc log stages: the port's spans and counters.

Counterpart of ``petibm_tpu/utils/timers.py``.  The reference registers a
log stage per solver phase (initialize, rhsVelocity, solveVelocity,
rhsPoisson, solvePoisson, update, write, monitor; navierstokes.cpp:99-199)
and dumps -log_view to logs/<ite>.log at every save (io.cpp:274).

A stage is a span: a name, a start and an end on
``time.perf_counter_ns``, and the span open around it (its parent), so
spans nest and a span's self time is its time less its children's.  The
store always keeps each span's aggregate under its path (the names from
the root down, joined by "/"): calls, total seconds and the first call's
seconds, which ``report()`` and the ``logs/<ite>.log`` dump list.  While
tracing is on (``start_tracing``) it also keeps every span's record and
the device stamps of each traced chunk or step (``utils/stamps.py``), in
buffers that hold the last ``KEEP`` root spans and stamp blocks.
Counters (``add``) sum under their name, and while tracing also on the
innermost open span's record.

While a ``torch.profiler`` is active, and only then, a span is also a
record function of its name, so a profiled run holds the program's spans
as host events on the clock of the card's events.  It is a plain function
scope (``_RecordFunctionFast``), not a user annotation
(``torch.profiler.record_function``): the profiler lays a user
annotation's range over the card's timeline too, from its first kernel to
its last, and a reader of the trace's device events would count the idle
time inside it as busy.

Code that holds no store (the kernel builds of ``_kernels.py``) opens its
spans with ``span`` in the store whose span is open innermost.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from collections import deque

import numpy as np
import torch

#: the root spans and the stamp blocks kept while tracing, the newest
KEEP = 1024
#: the stores with a span open, the innermost last (``span``, ``add``)
_ACTIVE: list = []


def span(name: str):
    """A span of ``name`` in the store whose span is open innermost; no
    span where none is open."""
    return _ACTIVE[-1].stage(name) if _ACTIVE else contextlib.nullcontext()


def add(name: str, value: float) -> None:
    """Add ``value`` to counter ``name`` of the store whose span is open
    innermost (none open: nothing)."""
    if _ACTIVE:
        _ACTIVE[-1].add(name, value)


def _profiling() -> bool:
    return bool(torch.autograd.profiler._is_profiler_enabled)


@dataclasses.dataclass(eq=False)
class Span:
    """One span's record: ``parent`` is the id of the span open around it
    (0: none), ``t0``/``t1`` its ends in ``perf_counter_ns``, ``counts``
    the counters added while it was the innermost."""

    id: int
    parent: int
    name: str
    t0: int = 0
    t1: int = 0
    counts: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(eq=False)
class StampBlock:
    """The device stamps of a traced chunk (k rows) or eager step (one):
    ``span`` the id of the span it ran in, ``ite0`` its first step,
    ``names`` the layout's stamp columns, ``rows`` the stamps (a device
    tensor until read), ``regions`` each accumulating region's first
    column (``stamps.Layout.regions``)."""

    span: int
    ite0: int
    names: list
    rows: object
    regions: dict = dataclasses.field(default_factory=dict)

    def values(self) -> np.ndarray:
        if isinstance(self.rows, torch.Tensor):
            self.rows = self.rows.cpu().numpy()
        return self.rows

    def region(self, name: str):
        """Region ``name``'s summed device ns and count of each step (two
        arrays), or None where the layout has no such region."""
        if name not in self.regions:
            return None
        col = self.regions[name]
        return self.values()[:, col + 1], self.values()[:, col + 2]


class StageTimers:
    def __init__(self):
        self.total: dict[str, float] = {}
        self.count: dict[str, int] = {}
        self.first: dict[str, float] = {}
        self.counters: dict[str, float] = {}
        #: per-instance records are kept while this is on
        self.tracing = False
        #: the stamps' clock (``utils/stamps.Clock``) of the tracing
        self.clock = None
        self._trees: deque = deque(maxlen=KEEP)
        self._pending: list = []
        self._stamps: deque = deque(maxlen=KEEP)
        self._open: list = []
        self._ids = itertools.count(1)

    @contextlib.contextmanager
    def stage(self, name: str):
        rf = None
        if _profiling():
            rf = torch._C._profiler._RecordFunctionFast(name)
            rf.__enter__()
        outer = self._open[-1] if self._open else None
        path = name if outer is None else f"{outer[0]}/{name}"
        rec = None
        if self.tracing:
            rec = Span(next(self._ids),
                       outer[1].id if outer and outer[1] else 0, name)
        self._open.append((path, rec))
        _ACTIVE.append(self)
        t0 = time.perf_counter_ns()
        try:
            yield rec
        finally:
            t1 = time.perf_counter_ns()
            _ACTIVE.pop()
            self._open.pop()
            dt = (t1 - t0) / 1e9
            self.total[path] = self.total.get(path, 0.0) + dt
            self.count[path] = self.count.get(path, 0) + 1
            self.first.setdefault(path, dt)
            if rec is not None:
                rec.t0, rec.t1 = t0, t1
                if rec.parent:
                    self._pending.append(rec)
                else:
                    self._trees.append(self._pending + [rec])
                    self._pending = []
            if rf is not None:
                rf.__exit__(None, None, None)

    def add(self, name: str, value: float) -> None:
        """Counter ``name`` += ``value`` (and on the innermost open span's
        record while tracing)."""
        self.counters[name] = self.counters.get(name, 0) + value
        if self._open and self._open[-1][1] is not None:
            counts = self._open[-1][1].counts
            counts[name] = counts.get(name, 0) + value

    # ------------------------------------------------------------------
    def start_tracing(self, clock) -> None:
        """Keep per-instance records from now on, the buffers emptied;
        ``clock`` is the stamps' clock."""
        self._trees.clear()
        self._pending = []
        self._stamps.clear()
        self.clock = clock
        self.tracing = True

    def stop_tracing(self) -> None:
        """Keep aggregates only; the records so far stay readable."""
        self.tracing = False

    def current_span(self) -> int:
        """The id of the innermost open span's record (0: none)."""
        rec = self._open[-1][1] if self._open else None
        return rec.id if rec is not None else 0

    def keep_stamps(self, block: StampBlock) -> None:
        self._stamps.append(block)

    def spans(self) -> list:
        """The kept records, by start."""
        recs = [r for tree in self._trees for r in tree] + self._pending
        return sorted(recs, key=lambda r: (r.t0, r.id))

    def stamp_blocks(self) -> list:
        """The kept stamp blocks, oldest first, each read to the host."""
        for block in self._stamps:
            block.values()
        return list(self._stamps)

    # ------------------------------------------------------------------
    def dump(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write("stage\tcalls\ttotal_s\tavg_s\n")
            for name, tot in sorted(self.total.items()):
                c = self.count[name]
                fh.write(f"{name}\t{c}\t{tot:.6f}\t{tot / max(c, 1):.6f}\n")
            if self.counters:
                fh.write("counter\ttotal\n")
                for name, val in sorted(self.counters.items()):
                    fh.write(f"{name}\t{val:g}\n")

    def report(self) -> str:
        return "; ".join(
            [f"{k}: {v:.3f}s/{self.count[k]}"
             for k, v in sorted(self.total.items())]
            + [f"{k}: {v:g}" for k, v in sorted(self.counters.items())])
