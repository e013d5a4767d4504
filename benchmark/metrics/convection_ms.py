"""Device ms a step of the convective term (the ghost extension and K3,
or its 2D twin): each step's ``convection`` region of the chunk's
stamps, the median over the span run's steps (``benchmark/spans.py``).
None off the card and where the program stamps no such region."""

import numpy as np

from benchmark.metrics.velocity_iteration_us import region_steps

REGION = "convection"


def read(run):
    steps = region_steps(run, REGION)
    per_step = [ns / 1e6 for ns, count in steps or () if count > 0]
    return float(np.median(per_step)) if per_step else None
