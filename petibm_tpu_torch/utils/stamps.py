"""Device stamps of a traced step: where a step's device time goes,
without a synchronise.

A traced step writes 2 + P stamps into row ``j`` of a float64 buffer, P
the step's phases (``solver._profile_phases()``): one at its start, one
after each phase (``chain_phases``, ``utils/profiling.py``) and one at
its end, after a chunk step's write-back and stats row
(``solvers/chunk.py``).  Then three columns for each accumulating region
of ``REGIONS``: its open stamp, its summed device nanoseconds and its
count (``region``); the step's first stamp sets them to 0.  The regions:
``vcycle``, a V-cycle of the pressure solve (``PoissonMG.cycle``,
``linalg/mg.py``); ``krylov.velocity``, an iteration of the velocity
solve's Krylov body (``linalg/krylov.py``, named where
``solvers/navierstokes.py`` builds the solve); ``convection``, the
convective term, its ghost extension with K3 or its 2D twin
(``NavierStokesSolver._rhs_velocity``).  In a masked loop copy
(``loops.masked``) a region counts only where the copy is kept, as
``_kernels.count_on_device`` counts its ``kept`` launches.

On the card a stamp is a one-thread kernel (``csrc/graph_cond.cu``) that
reads ``%globaltimer`` and stores it, less the clock's ``base``, as a
float64 nanosecond offset; a graph capture records it as a node and a
replay writes the row of its own step (``j`` is read on the card).  The
chunk's stamps sit in extra columns of its stats rows, so the chunk
still makes one host read.  On the CPU the same slots take
``time.perf_counter_ns()`` less the base: the layout's twin.

``Clock.calibrate`` puts the card's clock on the host's
``time.perf_counter_ns`` when tracing is switched on: a stamp launched
and synchronised ``TRIES`` times, the host clock read on both sides, the
tightest window kept.

Nothing here runs unless a step's stamps are made current (``use``): a
step captured or run outside ``use`` holds no stamp.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import time

import numpy as np
import torch

from .. import _kernels

#: the launch-and-synchronise windows ``Clock.calibrate`` takes the
#: tightest of
TRIES = 20
#: the stamps of the step being run or captured (``use``), innermost last
_CURRENT: list = []
#: the accumulating regions of a traced step, in the order of their
#: columns (the module docstring)
REGIONS = ("vcycle", "krylov.velocity", "convection")


def current():
    """The stamps the running step writes, or None."""
    return _CURRENT[-1] if _CURRENT else None


@contextlib.contextmanager
def use(stamps):
    """Make ``stamps`` (None: none) the ones the step inside writes."""
    if stamps is None:
        yield
        return
    _CURRENT.append(stamps)
    try:
        yield stamps
    finally:
        _CURRENT.pop()


@functools.cache
def _entries():
    """The C entry points of the stamp kernels, their signatures set."""
    lib = _kernels.library("graph_cond")
    ptr, i32, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
    sigs = {"graph_step_stamp": [ptr, ptr, ptr, i32, i32, i32, i32, u64,
                                 i32],
            "graph_region_stamp": [ptr, ptr, ptr, i32, i32, u64, i32, ptr],
            "graph_read_clock": [ptr, ptr],
            "graph_clock_steps": [ptr, ptr, i32]}
    out = {}
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        out[name] = fn
    return out


def _launch(name: str, device: torch.device, *args) -> None:
    err = _entries()[name](_kernels.stream(device), *args)
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {err}")


@dataclasses.dataclass
class Clock:
    """The stamps' clock: ``base`` (a device nanosecond reading) is taken
    off every stamp; ``offset`` is the device's clock less the host's
    ``perf_counter_ns``, within ``window_ns`` (the tightest calibration
    window); ``steps_ns`` the smallest and largest step of the device's
    clock as measured."""

    device: torch.device
    base: int
    offset: int
    window_ns: int
    steps_ns: tuple

    def host_ns(self, stamp):
        """A stamp (or an array of them) on the host's clock, in ns."""
        return np.asarray(stamp, np.float64) + (self.base - self.offset)

    @classmethod
    def calibrate(cls, device) -> "Clock":
        device = torch.device(device)
        if device.type != "cuda":
            now = time.perf_counter_ns()
            step = time.get_clock_info("perf_counter").resolution
            return cls(device, now, 0, 0, (int(step * 1e9),) * 2)
        buf = torch.zeros(2, dtype=torch.int64, device=device)
        best = None
        for _ in range(TRIES):
            torch.cuda.synchronize(device)
            h0 = time.perf_counter_ns()
            _launch("graph_read_clock", device, buf.data_ptr())
            torch.cuda.synchronize(device)
            h1 = time.perf_counter_ns()
            dev = int(buf[0].item())
            if best is None or h1 - h0 < best[0]:
                best = (h1 - h0, dev, (h0 + h1) // 2)
        window, dev, host = best
        _launch("graph_clock_steps", device, buf.data_ptr(), 256)
        steps = tuple(int(v) for v in buf.tolist())
        return cls(device, dev, dev - host, window, steps)


class Layout:
    """The stamp columns of one step: ``start``, one after each phase,
    ``end``; then each region's open stamp, nanoseconds and count from
    its column in ``regions``."""

    def __init__(self, phases: list):
        self.phases = list(phases)
        self.names = ["start", *self.phases, "end"]
        self.regions = {name: len(self.names) + 3 * i
                        for i, name in enumerate(REGIONS)}
        self.width = len(self.names) + 3 * len(REGIONS)


class Stamps:
    """The stamps of the steps that write row ``j[0]`` of ``rows``, in
    columns ``col0`` on (``layout.width`` of them), against ``clock``."""

    def __init__(self, layout: Layout, rows: torch.Tensor, col0: int,
                 j: torch.Tensor, clock: Clock):
        self.layout = layout
        self.rows = rows
        self.col0 = col0
        self.j = j
        self.clock = clock
        self.cuda = rows.is_cuda

    @classmethod
    def one_row(cls, layout: Layout, clock: Clock, device) -> "Stamps":
        """The stamps of one eager step: a one-row buffer of their own."""
        rows = torch.zeros((1, layout.width), dtype=torch.float64,
                           device=device)
        return cls(layout, rows, 0,
                   torch.zeros(1, dtype=torch.int64, device=device), clock)

    def _now(self) -> float:
        return float(time.perf_counter_ns() - self.clock.base)

    def stamp(self, index: int) -> None:
        """Stamp column ``index`` of the layout (0, the step's start, also
        sets the regions' columns to 0)."""
        col = self.col0 + index
        aux = self.col0 + len(self.layout.names)
        naux = self.layout.width - len(self.layout.names)
        if self.cuda:
            _launch("graph_step_stamp", self.rows.device,
                    self.rows.data_ptr(), self.j.data_ptr(),
                    self.rows.shape[1], col, aux, naux, self.clock.base,
                    int(index == 0))
            return
        row = self.rows[int(self.j[0])]
        row[col] = self._now()
        if index == 0:
            row[aux:aux + naux] = 0.0

    def end(self) -> None:
        self.stamp(len(self.layout.names) - 1)

    def region(self, name: str, close: bool) -> None:
        """Open (``close`` false) or close region ``name``: the close adds
        its device nanoseconds and 1 to the row's columns of the region,
        times the kept flag of the masked copy it runs in."""
        from ..linalg.loops import MASK

        col = self.col0 + self.layout.regions[name]
        kept = MASK[-1] if MASK else None
        if self.cuda:
            _launch("graph_region_stamp", self.rows.device,
                    self.rows.data_ptr(), self.j.data_ptr(),
                    self.rows.shape[1], col, self.clock.base, int(close),
                    None if kept is None else kept.data_ptr())
            return
        row = self.rows[int(self.j[0])]
        now = self._now()
        if not close:
            row[col] = now
            return
        keep = 1.0 if kept is None else float(bool(kept))
        row[col + 1] += keep * (now - float(row[col]))
        row[col + 2] += keep


def stamp(index: int) -> None:
    """Stamp column ``index`` of the current step, if it has stamps."""
    if _CURRENT:
        _CURRENT[-1].stamp(index)


@contextlib.contextmanager
def region(name: str):
    """Region ``name``'s open and close stamps around the block, if the
    current step has stamps."""
    st = current()
    if st is None:
        yield
        return
    st.region(name, False)
    yield
    st.region(name, True)
