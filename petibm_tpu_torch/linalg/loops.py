"""The solver loops' drivers: how a loop body runs until its predicate
falls.

Counterpart of ``jax.lax.while_loop`` and ``jax.lax.cond`` in the JAX
package's solves.  A loop here is a body that updates its carries in
place (the iterate, the residual, the counter ``it``, the predicate
``pred`` itself: a 0-d bool tensor on the fields' device) and a
predicate the body recomputes.  Two drivers run the same body:

- ``HostDriver`` (the default) reads the predicate on the host before
  each iteration, so a loop runs exactly as long as it needs to: the
  results of the JAX ``while_loop``.  ``advance()`` and every solve
  outside a chunk take it.
- ``GuardedDriver`` lays out ``cap`` copies of the body, each under
  ``guard(pred, carries)``, and reads nothing on the host.  Captured in
  a CUDA graph, a guard is a conditional IF node whose skipped body
  launches nothing (``utils/graphs.py``; PyTorch offers no WHILE node,
  hence the capped unroll); on the CPU it is ``if bool(pred):``, the
  plain twin of the graph.  An IF node's body takes no NCCL collective
  (``scripts/probe_nccl_graph_if.py``: "invalid argument"), so the
  loops of a decomposed run on the card take ``masked``: every copy
  runs, and each carry keeps its old value where the predicate was
  false, bit for bit what a skipped body leaves.  A loop that still
  wants to run after its last copy has overflowed: the driver records
  the predicate after the copies for the caller to read
  (``Site.overflow``).  A branch (``cond``) is one guard.

Rule of the guarded driver: a tensor allocated inside a skipped body
holds garbage, so everything read after a guard lives in the carries,
which each site names (the tensors its body updates in place).

``use(driver)`` makes a driver current for the solves inside it; the
sites (loops and branches) a step opens are numbered in the order it
opens them, which is the same in every step.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass
class Site:
    """One loop or branch of a step, as a driver ran it: ``cap`` copies of
    its body (1 for a branch); ``overflow`` (a device bool, loops only) is
    the predicate after the last copy; ``body_nodes`` the graph nodes one
    copy adds (capture only); ``iterations`` the host count
    (``HostDriver``'s)."""

    kind: str
    cap: int = 1
    maxiter: int = 1
    overflow: object = None
    body_nodes: int = 0
    iterations: int = 0


class HostDriver:
    """Reads the predicate before each iteration (a host read each), as
    the loops ran before chunks existed; records each site's iterations
    when ``record`` is set (the warm-up step that sets the caps)."""

    def __init__(self, record: bool = False):
        self.sites: list[Site] | None = [] if record else None

    def loop(self, kind: str, body, pred, maxiter: int, carries) -> None:
        n = 0
        while bool(pred):
            body()
            n += 1
        if self.sites is not None:
            self.sites.append(Site(kind, maxiter=maxiter, iterations=n))

    def cond(self, pred, body, carries) -> None:
        if bool(pred):
            body()
        if self.sites is not None:
            self.sites.append(Site("cond"))


def cpu_guard(pred, carries):
    """The CPU twin of a graph's IF node."""
    return contextlib.nullcontext() if bool(pred) else None


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [t for item in tree for t in _leaves(item)]


#: the predicate of the masked body being run (a 0-d bool tensor), for
#: the kernels' device launch counters (``_kernels.count_launch``)
MASK: list = []


@contextlib.contextmanager
def masked(pred, carries):
    """A guard that runs its block on every device and keeps it only
    where ``pred`` holds: the carries (and ``pred``) are copied before the
    block and written back where ``pred`` was false, so each ends as a
    skipped body leaves it.  Reads nothing on the host."""
    keep = pred.clone()
    held = [pred] + [t for t in _leaves(carries) if t is not pred]
    old = [t.clone() for t in held]
    MASK.append(keep)
    try:
        yield
    finally:
        MASK.pop()
    for t, o in zip(held, old):
        t.copy_(torch.where(keep, t, o))


class GuardedDriver:
    """Runs ``caps[i]`` guarded copies of the body of site i; ``guard(pred,
    carries)`` returns a context manager that runs its block only where
    ``pred`` is true, or keeps its writes to ``carries`` only there
    (``masked``), or None to skip the block (the CPU twin decides on the
    host).
    The first copy of each body counts its graph nodes with ``nodes()``
    where given (capture)."""

    def __init__(self, caps: list[int], guard, nodes=None):
        self.caps = list(caps)
        self.guard = guard
        self.nodes = nodes
        self.sites: list[Site] = []
        self._inside = False

    def _guarded(self, site: Site, pred, body, carries, first: bool) -> None:
        ctx = self.guard(pred, carries)
        if ctx is None:
            return
        if self._inside:
            raise RuntimeError("a loop inside a guarded body: the guarded "
                               "driver does not nest sites")
        self._inside = True
        try:
            with ctx:
                body()
                if first and self.nodes is not None:
                    site.body_nodes = self.nodes()
        finally:
            self._inside = False

    def _site(self, kind: str) -> Site:
        i = len(self.sites)
        if i >= len(self.caps):
            raise RuntimeError(f"site {i} ({kind}) has no cap: the step "
                               "opened more sites than its warm-up")
        site = Site(kind, cap=1 if kind == "cond" else self.caps[i])
        self.sites.append(site)
        return site

    def loop(self, kind: str, body, pred, maxiter: int, carries) -> None:
        site = self._site(kind)
        site.maxiter = maxiter
        for j in range(site.cap):
            self._guarded(site, pred, body, carries, j == 0)
        site.overflow = pred.clone()

    def cond(self, pred, body, carries) -> None:
        self._guarded(self._site("cond"), pred, body, carries, True)


_DRIVER = [HostDriver()]


def current():
    return _DRIVER[-1]


@contextlib.contextmanager
def use(driver):
    """Make ``driver`` the one the solves inside the block run on."""
    _DRIVER.append(driver)
    try:
        yield driver
    finally:
        _DRIVER.pop()


def loop(kind: str, body, pred, maxiter: int, carries) -> None:
    """Run ``body`` while ``pred`` holds, on the current driver; ``body``
    advances the loop's device counter, and ``pred`` fails once that
    reaches ``maxiter``.  ``carries``: the tensors (nested in dicts and
    sequences) that ``body`` updates in place, ``pred`` among them."""
    current().loop(kind, body, pred, maxiter, carries)


def cond(pred, body, carries) -> None:
    """Run ``body`` where ``pred`` holds, on the current driver (a branch
    whose results ``body`` writes into ``carries``)."""
    current().cond(pred, body, carries)
