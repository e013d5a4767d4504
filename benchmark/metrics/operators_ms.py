"""Device ms a step of the phases that apply operators rather than
solve (moveIB, rhsVelocity, rhsForces, applyNoSlip, rhsPoisson, update:
stencils, convection, spreading and interpolation, boundary updates),
their stamped spans summed a step, the median over the span run's steps
(``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    s = spans.of(run)
    return None if s is None else s.operators_ms()
