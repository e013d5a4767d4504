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
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..linalg import loops
from ..parallel import dist as pdist
from ..utils import graphs

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
        #: the capture's numbers: seconds, nodes, memory, caps
        self.info: dict = {}
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
        t0 = time.perf_counter()
        state = pytree.tree_map(torch.clone, self.solver.state)
        driver = loops.HostDriver(record=True)
        with self._side(), loops.use(driver):
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
        self.info["warmup_s"] = time.perf_counter() - t0
        self.capture()

    def _step_into_static(self, driver) -> None:
        """One step from the static buffers back into them, its row into
        ``rows[j]``; ``j += 1``."""
        state = pytree.tree_unflatten(self.static, self.spec)
        with loops.use(driver):
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
        self.rows.index_copy_(0, self.j, row.unsqueeze(0))
        self.j.add_(1)

    def capture(self) -> None:
        """The static buffers and, on the card, the step's graph."""
        leaves, self.spec = pytree.tree_flatten(self.solver.state)
        self.static = [t.clone() for t in leaves]
        self.j = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.graph = None
        if self.cuda:
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
            t0 = time.perf_counter()
            with graphs.capture(graph, pool, self.stream):
                self._step_into_static(driver)
            t1 = time.perf_counter()
            # what the capture counted is one replay's: taken back here,
            # added per replay by ``run``
            after = pdist.counters()
            self.step_comm = {k: [after[k]["calls"] - v["calls"],
                                  after[k]["bytes"] - v["bytes"]]
                              for k, v in before.items()}
            for k, (calls, nbytes) in self.step_comm.items():
                pdist.COUNTERS[k][0] -= calls
                pdist.COUNTERS[k][1] -= nbytes
            graph.instantiate()
            torch.cuda.synchronize(dev)
            top = graphs.graph_nodes(graph.raw_cuda_graph())
            self.graph = graph
            self.info.update(
                capture_s=t1 - t0, instantiate_s=time.perf_counter() - t1,
                top_nodes=top, nodes=top + sum(s.cap * s.body_nodes
                                               for s in driver.sites),
                peak_bytes=torch.cuda.max_memory_allocated(dev) - mem0,
                held_bytes=torch.cuda.memory_allocated(dev) - mem0)
        self.info["caps"] = list(self.caps)

    # ------------------------------------------------------------------
    def run(self):
        """k steps from the solver's state.  Returns the k stats dicts,
        or None where a loop overflowed (the solver's state is then
        unchanged)."""
        leaves, spec = pytree.tree_flatten(self.solver.state)
        if spec != self.spec:
            raise RuntimeError("the solver's state changed its structure "
                               "since the capture")
        for s, v in zip(self.static, leaves):
            s.copy_(v)
        self.j.zero_()
        if self.cuda:
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(self.k):
                    self.graph.replay()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            for k, (calls, nbytes) in self.step_comm.items():
                pdist.COUNTERS[k][0] += self.k * calls
                pdist.COUNTERS[k][1] += self.k * nbytes
        else:
            guard = loops.masked if self.masked else loops.cpu_guard
            for _ in range(self.k):
                self._step_into_static(loops.GuardedDriver(self.caps, guard))
        rows = self.rows.cpu().numpy()  # the chunk's one host read
        width = self.layout.width
        overflow = np.array(self._agree(
            rows[:, width:].any(axis=0).astype(np.int64).tolist()), bool)
        if overflow.any():
            self.caps = [min(site.maxiter, 2 * cap) if over else cap
                         for cap, site, over in zip(self.caps, self.sites,
                                                    overflow)]
            return None
        self.solver.state = pytree.tree_unflatten(
            [t.clone() for t in self.static], self.spec)
        return [self.layout.unpack(r) for r in rows[:, :width]]

