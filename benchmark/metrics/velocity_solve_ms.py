"""Device ms of the step's solveVelocity phase, between its stamps in the
chunk's captured step, the median over the span run's steps
(``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    s = spans.of(run)
    return None if s is None else s.phase_median_ms("solveVelocity")
