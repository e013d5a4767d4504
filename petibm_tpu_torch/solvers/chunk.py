"""The chunked step: ``stepsPerDispatch`` steps a host round trip.

Counterpart of the JAX package's ``jax.lax.scan`` over its jitted step
(``petibm_tpu/solvers/navierstokes.py:183-204``, ``advance_chunk`` at
``:729-738``).  At the first chunk:

1. warm-up: one step through the host driver (``linalg/loops.py``) on a
   throwaway copy of the state, on the capture's side stream, which
   builds the kernels, the cuFFT plans and the cuBLAS workspaces outside
   the capture, and counts each loop's iterations;
2. caps: each loop gets ``min(max_it, max(4, 2 x its iterations))``
   guarded copies of its body (a branch one);
3. capture: on the card, one step as a CUDA graph under the guarded
   driver, which reads the state from static buffers, writes the new
   state back into them (the step's outputs copied in place: one copy of
   the state a step), and writes the step's stats and each loop's
   overflow flag into row ``j`` of a (k, columns) float64 buffer, ``j`` a
   device counter.  On the CPU each chunk step runs the guarded driver
   with ``if bool(pred):`` as its guard: the graph's plain twin.

A chunk copies the state into the static buffers, replays the graph k
times (under ``torch.cuda.set_sync_debug_mode("error")``) and reads the
rows to the host: its one host read.  Where a loop overflowed its cap,
the chunk is thrown away (the solver's state is still the chunk's
start), the k steps run through the host driver, the caps of the loops
that overflowed double and the step is captured again
(``chunk_overflows``).

With tracing on (``trace``; ``solver.trace_spans``) a second graph is
captured beside the plain one: the same step with its device stamps
(``utils/stamps.py``), sharing the static buffers and ``j``, its stats
rows ``stamps.Layout.width`` columns wider to hold them, so a chunk still
makes one host read.  Switching tracing off goes back to the plain graph,
which is kept as it was captured.  A chunk's host spans (``chunk.copy_in``,
``chunk.replay``, ``chunk.read``, ``chunk.unpack``; ``chunk.capture`` with
``warmup``, ``capture`` and ``instantiate``) go to ``solver.timers``.

A capture launches nothing, so the kernel wrappers' host counters count
no launch there (``_kernels.count_launch``), and a replay does not enter
the wrappers: a graph captured while ``_kernels.count_on_device`` is on
counts its replays' launches on the card.

On a decomposed run (``solver.part``) every rank runs its own chunk of
the same step, in lockstep through the step's collectives:

- every loop predicate comes from a replicated reduction, so all ranks
  take the same branch; the caps (the largest any rank's warm-up asks
  for) and the overflow flags (any rank's) are agreed over the group, so
  every rank captures the same collectives and all rerun together;
- on the card, an IF node's body takes no NCCL collective
  (``scripts/probe_nccl_graph_if.py``), so every copy of a loop body is
  captured at the graph's top level and masked (``loops.masked``,
  ``masks_loops``): the results are bit for bit those of skipped bodies,
  at the cost of running every copy.  The warm-up step runs the step's
  collectives first, so NCCL's communicators (the layer groups', the
  point-to-point pairs') exist before the capture;
- a replay enters no collective's Python, so the collective counters
  of ``parallel/dist.py`` count none: the capture's count is one step's
  (every copy runs in every replay) and a chunk adds it k times.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..linalg import loops
from ..parallel import dist as pdist
from ..utils import graphs, stamps
from ..utils.timers import StampBlock

#: the fewest copies of a loop's body a capture lays out
MIN_CAP = 4

_NP = {torch.float32: np.float32, torch.float64: np.float64,
       torch.bool: np.bool_, torch.int64: np.int64}


def _host_value(vals: np.ndarray, shape: tuple, dtype: torch.dtype):
    """A stat's host value from its float64 columns: a Python scalar for a
    0-d stat, else an array of the stat's dtype (exact: every stat's
    values are float64 numbers)."""
    if shape == ():
        if dtype == torch.bool:
            return bool(vals[0])
        if dtype == torch.int64:
            return int(vals[0])
        return float(vals[0])
    return vals.astype(_NP[dtype]).reshape(shape)


class StatsLayout:
    """The columns of a step's stats, in float64: each stat's values
    flattened, in the stats dict's order."""

    def __init__(self, stats: dict):
        self.keys = list(stats)
        self.shapes = {k: tuple(stats[k].shape) for k in self.keys}
        self.dtypes = {k: stats[k].dtype for k in self.keys}
        self.sizes = [int(np.prod(self.shapes[k], dtype=np.int64))
                      for k in self.keys]
        self.width = sum(self.sizes)

    def pack(self, stats: dict) -> torch.Tensor:
        return torch.cat([stats[k].reshape(-1).to(torch.float64)
                          for k in self.keys])

    def unpack(self, row: np.ndarray) -> dict:
        out, at = {}, 0
        for key, n in zip(self.keys, self.sizes):
            out[key] = _host_value(row[at:at + n], self.shapes[key],
                                   self.dtypes[key])
            at += n
        return out


def scalar_stats(stats: dict) -> dict:
    """The 0-d stats (the iterations log's; not the forces)."""
    return {k: v for k, v in stats.items() if v.dim() == 0}


def masks_loops(solver) -> bool:
    """Whether the chunk runs its loops' copies masked (``loops.masked``)
    rather than under IF nodes (on the CPU: ``if bool(pred):``): a
    decomposed run on the card, whose loop bodies hold NCCL
    collectives."""
    return solver.part is not None and solver.device.type == "cuda"


def _write_back(static: list, new: list) -> None:
    """Copy the step's new state into the static buffers; an output that
    shares memory with another buffer is copied out first, so no copy
    reads a buffer an earlier one overwrote."""
    ptrs = {t.untyped_storage().data_ptr() for t in static}
    safe = [n if n is s or n.untyped_storage().data_ptr() not in ptrs
            else n.clone() for s, n in zip(static, new)]
    for s, n in zip(static, safe):
        if n is not s:
            s.copy_(n)


class ChunkRunner:
    """The chunk engine of one solver (``solver.advance_chunk``)."""

    def __init__(self, solver):
        self.solver = solver
        self.k = solver.steps_per_dispatch
        self.device = solver.device
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.caps: list[int] = []
        #: the step's loops and branches, as its warm-up ran them
        self.sites: list[loops.Site] = []
        self.graph = None
        #: the capture's numbers: nodes, memory, caps
        self.info: dict = {}
        #: whether chunks run the stamped step (``trace``), and its graph
        #: and rows while they do
        self.tracing = False
        self.traced: Traced | None = None
        #: the chunk's stats rows (``prepare``)
        self.rows: torch.Tensor | None = None
        self.masked = masks_loops(solver)
        #: one step's collectives (``parallel/dist.py`` COUNTERS), as the
        #: capture counted them: a replay adds them on the card
        self.step_comm: dict = {}

    def _agree(self, values: list) -> list:
        """The largest of every rank's ``values`` (ints) over the process
        group (each rank's own without one): one host round trip."""
        if self.solver.part is None or not values:
            return list(values)
        import torch.distributed as dist

        t = torch.tensor(values, dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t.tolist()

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _side(self):
        """The capture's side stream (the CPU runs in place)."""
        if not self.cuda:
            yield
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            yield
        torch.cuda.current_stream(self.device).wait_stream(self.stream)

    def prepare(self) -> None:
        """Warm-up, caps, capture (the module docstring's steps 1-3)."""
        state = pytree.tree_map(torch.clone, self.solver.state)
        driver = loops.HostDriver(record=True)
        with (self.solver.timers.stage("warmup"), self._side(),
              loops.use(driver)):
            _, stats = self.solver._step_fn(state)
        self.sites = driver.sites
        self.caps = self._agree(
            [1 if s.kind == "cond"
             else min(s.maxiter, max(MIN_CAP, 2 * s.iterations))
             for s in self.sites])
        # the rows outlive a replay: allocated before any capture (a
        # graph reuses the memory of what it freed before an allocation)
        self.layout = StatsLayout(stats)
        self.rows = torch.empty(
            (self.k, self.layout.width + len(self.sites)),
            dtype=torch.float64, device=self.device)
        self.capture()

    def _step_into_static(self, driver, rows: torch.Tensor,
                          st: stamps.Stamps | None = None) -> None:
        """One step from the static buffers back into them, its row into
        ``rows[j]`` (the stamped step's ``rows`` wider, its stamps in the
        extra columns, ``st``); ``j += 1``."""
        state = pytree.tree_unflatten(self.static, self.spec)
        with loops.use(driver), stamps.use(st):
            new_state, stats = self.solver._step_fn(state)
        new, spec = pytree.tree_flatten(new_state)
        if spec != self.spec:
            raise RuntimeError("the step changed the state's structure")
        _write_back(self.static, new)
        zero = torch.zeros((), dtype=torch.bool, device=self.device)
        overflow = [zero if s.overflow is None else s.overflow
                    for s in driver.sites]
        row = torch.cat([self.layout.pack(stats),
                         torch.stack(overflow).to(torch.float64)])
        if row.numel() != self.rows.shape[1]:
            raise RuntimeError("the step's stats changed their layout")
        out = rows if rows is self.rows else rows.narrow(1, 0, row.numel())
        out.index_copy_(0, self.j, row.unsqueeze(0))
        if st is not None:
            st.end()
        self.j.add_(1)

    def capture(self) -> None:
        """The static buffers and, on the card, the step's graph; with
        tracing on, the stamped step's too."""
        leaves, self.spec = pytree.tree_flatten(self.solver.state)
        self.static = [t.clone() for t in leaves]
        self.j = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.graph = None
        self.traced = None
        if self.cuda:
            self.graph, info = self._graph(self.rows)
            self.info.update(info)
        self.info["caps"] = list(self.caps)
        if self.tracing:
            self._capture_traced()

    def _graph(self, rows: torch.Tensor, st=None) -> tuple:
        """The step captured as a CUDA graph writing ``rows`` (stamped by
        ``st``): the instantiated graph and its nodes and memory."""
        timers = self.solver.timers
        dev = self.device
        torch.cuda.synchronize(dev)
        mem0 = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        pool = torch.cuda.graph_pool_handle()
        driver = (loops.GuardedDriver(self.caps, loops.masked)
                  if self.masked else
                  loops.GuardedDriver(self.caps, graphs.IfNodes(dev),
                                      graphs.capturing_graph_nodes))
        before = pdist.counters()
        with timers.stage("capture"):
            with graphs.capture(graph, pool, self.stream):
                self._step_into_static(driver, rows, st)
        # what the capture counted is one replay's: taken back here,
        # added per replay by ``run``
        after = pdist.counters()
        self.step_comm = {k: [after[k]["calls"] - v["calls"],
                              after[k]["bytes"] - v["bytes"]]
                          for k, v in before.items()}
        for k, (calls, nbytes) in self.step_comm.items():
            pdist.COUNTERS[k][0] -= calls
            pdist.COUNTERS[k][1] -= nbytes
        with timers.stage("instantiate"):
            graph.instantiate()
            torch.cuda.synchronize(dev)
        top = graphs.graph_nodes(graph.raw_cuda_graph())
        return graph, dict(
            top_nodes=top, nodes=top + sum(s.cap * s.body_nodes
                                           for s in driver.sites),
            peak_bytes=torch.cuda.max_memory_allocated(dev) - mem0,
            held_bytes=torch.cuda.memory_allocated(dev) - mem0)

    # ------------------------------------------------------------------
    def trace(self, on: bool) -> None:
        """Run the stamped step from the next chunk on (``on``), its graph
        captured now; or go back to the plain graph, the stamped one
        dropped."""
        self.tracing = bool(on)
        if not on:
            self.traced = None
        elif self.traced is None and self.rows is not None:
            self._capture_traced()

    def _capture_traced(self) -> None:
        """The stamped step's rows (the plain rows' columns, then the
        stamps') and, on the card, its graph."""
        layout = self.solver.stamp_layout
        width = self.rows.shape[1]
        rows = torch.zeros((self.k, width + layout.width),
                           dtype=torch.float64, device=self.device)
        st = stamps.Stamps(layout, rows, width, self.j,
                           self.solver.timers.clock)
        graph, info = (self._graph(rows, st) if self.cuda else (None, {}))
        self.traced = Traced(graph, rows, st, info)

    # ------------------------------------------------------------------
    def run(self):
        """k steps from the solver's state.  Returns the k stats dicts,
        or None where a loop overflowed (the solver's state is then
        unchanged)."""
        timers = self.solver.timers
        chunk_span = timers.current_span()
        traced = self.traced if self.tracing else None
        graph, rows = ((self.graph, self.rows) if traced is None
                       else (traced.graph, traced.rows))
        with timers.stage("chunk.copy_in"):
            leaves, spec = pytree.tree_flatten(self.solver.state)
            if spec != self.spec:
                raise RuntimeError("the solver's state changed its "
                                   "structure since the capture")
            for s, v in zip(self.static, leaves):
                s.copy_(v)
            self.j.zero_()
        with timers.stage("chunk.replay"):
            if self.cuda:
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    for _ in range(self.k):
                        graph.replay()
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
                for k, (calls, nbytes) in self.step_comm.items():
                    pdist.COUNTERS[k][0] += self.k * calls
                    pdist.COUNTERS[k][1] += self.k * nbytes
            else:
                guard = loops.masked if self.masked else loops.cpu_guard
                st = None if traced is None else traced.stamps
                for _ in range(self.k):
                    self._step_into_static(
                        loops.GuardedDriver(self.caps, guard), rows, st)
        with timers.stage("chunk.read"):
            host = rows.cpu().numpy()  # the chunk's one host read
        with timers.stage("chunk.unpack"):
            width = self.layout.width
            ends = width + len(self.sites)
            overflow = np.array(self._agree(
                host[:, width:ends].any(axis=0).astype(np.int64).tolist()),
                bool)
            if overflow.any():
                self.caps = [min(site.maxiter, 2 * cap) if over else cap
                             for cap, site, over in zip(self.caps,
                                                        self.sites,
                                                        overflow)]
                return None
            if traced is not None:
                layout = traced.stamps.layout
                timers.keep_stamps(StampBlock(
                    chunk_span, self.solver.ite + 1, layout.names,
                    host[:, ends:].copy(), layout.regions))
            self.solver.state = pytree.tree_unflatten(
                [t.clone() for t in self.static], self.spec)
            return [self.layout.unpack(r) for r in host[:, :width]]


@dataclasses.dataclass
class Traced:
    """The stamped step of a chunk runner: its graph (None on the CPU),
    its rows and stamps, and the capture's nodes and memory."""

    graph: object
    rows: torch.Tensor
    stamps: stamps.Stamps
    info: dict

