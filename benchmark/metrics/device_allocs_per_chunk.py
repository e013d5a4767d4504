"""Allocations the caching allocator asked of the CUDA driver a chunk
(``torch.cuda.memory_stats()["num_device_alloc"]``, the difference over
the ``chunk`` span, which records it while tracing), the mean over the
span run's chunks (``benchmark/spans.py``): a replayed chunk should
need none."""

from benchmark import spans


def read(run):
    s = spans.of(run)
    return None if s is None else s.allocs_per_chunk()
