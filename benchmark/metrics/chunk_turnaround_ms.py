"""Device ms from a chunk's last step's end stamp to the next chunk's
first step's start stamp, the median over the chunk boundaries of the
span run (``benchmark/spans.py``): the host read, the unpack, the
output and the next copy-in and launch, as the card waits through
them."""

import numpy as np

from benchmark import spans


def read(run):
    s = spans.of(run)
    if s is None or not len(s.turnarounds_ms()):
        return None
    return float(np.median(s.turnarounds_ms()))
