"""CUDA graph helpers of the chunked step: the IF-node guard and the
graph's node count.

``IfNodes`` opens conditional IF nodes in the graph being captured: a
block inside ``guard(pred)`` is captured into the node's body, which a
replay runs only where the 0-d bool ``pred`` is true when the node is
reached.  PyTorch 2.11 has no such call (its ``CUDAGraph`` lacks
``begin_capture_to_if_node``), so the node is made by the CUDA runtime
in ``csrc/graph_cond.cu`` and the body is captured on a child stream,
whose allocations go to the graph's own pool (``capture``), as the outer
capture's do (a tensor allocated in one replay and read in the next must
therefore be allocated before the capture).  The node counts come from
the CUDA driver (``cuGraphGetNodes``; ``cuStreamGetCaptureInfo`` names
the graph a stream is capturing into, a body graph inside an IF node)
through ctypes.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from .. import _kernels

#: the capture mode of the graph and of every body (cudaStreamCaptureMode
#: relaxed: an allocation may take memory from the driver)
_RELAXED = 2


@functools.cache
def _libcuda():
    return ctypes.CDLL("libcuda.so.1")


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err}")


class IfNodes:
    """The guards of one capture (``capture``) on ``device``:
    ``guard(pred, carries)`` is a context manager whose block goes into a
    new IF node's body (``carries`` unread: a skipped body writes
    nothing)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.child = torch.cuda.Stream(self.device)
        # the child stream's cuBLAS workspace, taken now and not in a body
        with torch.cuda.stream(self.child):
            for dtype in (torch.float32, torch.float64):
                a = torch.ones((2, 2), dtype=dtype, device=self.device)
                a @ a
        torch.cuda.current_stream(self.device).wait_stream(self.child)
        lib = _kernels.library("graph_cond")
        self._begin = lib.graph_if_begin
        self._begin.restype = ctypes.c_int
        self._begin.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
        self._end = lib.graph_if_end
        self._end.restype = ctypes.c_int
        self._end.argtypes = [ctypes.c_void_p]

    @contextlib.contextmanager
    def __call__(self, pred: torch.Tensor, carries=()):
        if pred.dtype != torch.bool or not pred.is_cuda:
            raise ValueError("an IF node's predicate is a bool on the "
                             "capture's device")
        main = torch.cuda.current_stream(self.device)
        _check(self._begin(main.cuda_stream, pred.data_ptr(),
                           self.child.cuda_stream, _RELAXED),
               "opening an IF node")
        try:
            with torch.cuda.stream(self.child):
                yield
        finally:
            _check(self._end(self.child.cuda_stream), "closing an IF node")


@contextlib.contextmanager
def capture(graph, pool, stream):
    """``torch.cuda.graph`` into ``pool`` on ``stream``, in which every
    allocation of this thread goes to the graph's pool: the capture's own
    filter takes only the capturing stream's, and the child stream of an
    IF node's body captures with an id of its own.  The allocator keeps
    one filter a pool, so the capture's is swapped for this thread's,
    which the capture's end removes."""
    with torch.cuda.graph(graph, pool=pool, stream=stream,
                          capture_error_mode="relaxed"):
        index = torch.cuda.current_device()
        torch._C._cuda_endAllocateToPool(index, pool)
        torch._C._cuda_beginAllocateCurrentThreadToPool(index, pool)
        torch._C._cuda_releasePool(index, pool)  # the begin counted a use
        yield


def graph_nodes(graph: int) -> int:
    """The nodes of the CUDA graph ``graph`` (a ``cudaGraph_t``), not
    counting those inside its conditional nodes' bodies."""
    n = ctypes.c_size_t(0)
    _check(_libcuda().cuGraphGetNodes(ctypes.c_void_p(graph), None,
                                      ctypes.byref(n)), "cuGraphGetNodes")
    return n.value


def capturing_graph_nodes() -> int:
    """The nodes captured so far into the graph the current stream is
    capturing into (an IF node's body, inside ``IfNodes``)."""
    status = ctypes.c_int(0)
    ident = ctypes.c_ulonglong(0)
    graph = ctypes.c_void_p(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    _check(_libcuda().cuStreamGetCaptureInfo_v2(
        stream, ctypes.byref(status), ctypes.byref(ident),
        ctypes.byref(graph), None, None), "cuStreamGetCaptureInfo")
    if status.value != 1:  # CU_STREAM_CAPTURE_STATUS_ACTIVE
        raise RuntimeError("the current stream is not capturing")
    return graph_nodes(graph.value)
