"""Device us of one iteration of the velocity solve's Krylov body
(BiCGStab or CG): each step's summed ``krylov.velocity`` region of the
chunk's stamps over its count, the median over the span run's steps that
iterate (``benchmark/spans.py``).  None off the card and where the
program stamps no such region."""

import numpy as np

from benchmark import spans

REGION = "krylov.velocity"


def region_steps(run, name):
    """(device ns, count) of the region ``name`` in each step of the span
    run's whole chunks; None off the card, empty where the program stamps
    no such region."""
    if spans.of(run) is None:
        return None
    out = []
    for block in run.solver.timers.stamp_blocks():
        region = getattr(block, "region", None)
        got = region(name) if region is not None else None
        if got is not None and len(block.values()) == run.cell.k:
            out.extend(zip(*got))
    return out


def read(run):
    steps = region_steps(run, REGION)
    per_step = [ns / count / 1e3 for ns, count in steps or () if count > 0]
    return float(np.median(per_step)) if per_step else None
