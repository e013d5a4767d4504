"""The yardstick's arithmetic: the card's peaks, the bytes each measured
operation must move, and a roofline share from them.

Bytes are counted from shapes: every input array read once and every
output array written once, whatever a kernel reads again.  Nothing here
imports the program.
"""

from __future__ import annotations

import math

#: one NVIDIA H100 SXM's HBM3 bandwidth (bytes/s) and dense peak rates
#: outside sparsity (operations/s), NVIDIA's data sheet at 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12,
            "tf32": 495e12}
ITEMSIZE = {"float32": 4, "float64": 8, "bfloat16": 2}


def cells(shape) -> int:
    return int(math.prod(int(n) for n in shape))


def poisson_apply_bytes(p_shape, dtype: str = "float32") -> int:
    """The pressure operator's apply: the field read, the result written."""
    return 2 * cells(p_shape) * ITEMSIZE[dtype]


def convection_bytes(velocity_shapes, dtype: str = "float32") -> int:
    """The 3D convection term of (u, v, w): three fields read, three
    written."""
    return 2 * sum(cells(s) for s in velocity_shapes) * ITEMSIZE[dtype]


def line_sweep_bytes(p_shape, dtype: str = "float32") -> int:
    """One damped line-Jacobi sweep in every direction of a level: per
    direction the iterate and the right side read, the iterate written."""
    return len(p_shape) * 3 * cells(p_shape) * ITEMSIZE[dtype]


def bound_s(nbytes: float, ops: float = 0.0, dtype: str = "float32") -> float:
    """The least time the card could take for ``nbytes`` moved once and
    ``ops`` operations: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype])


def roofline_pct(seconds: float, nbytes: float, ops: float = 0.0,
                 dtype: str = "float32") -> float:
    """The measured time's share of its bound, in %."""
    return 100.0 * bound_s(nbytes, ops, dtype) / seconds
