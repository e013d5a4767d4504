"""Truncated-series approximate inverse B_N of the velocity operator.

Counterpart of ``petibm_tpu/operators/bn.py`` (bn.py:20; reference:
createbn.cpp:19-96): ``A = I/dt - coeff*L`` and
``B_N = dt*I + sum_{k=2..N} dt^k * coeff^(k-1) * L^(k-1)``, applied as
k-1 homogeneous Laplacian sweeps.  The solvers of this slice take N = 1.
"""

from __future__ import annotations


def make_bn(laplacian, dt: float, coeff: float, order: int = 1):
    """``bn(g)`` applying B_N to a velocity-space dict ``g``; ``laplacian``
    is the closure of ``make_laplacian``, ``coeff`` the implicit diffusion
    coefficient times nu."""
    if order < 1:
        raise ValueError(f"BN order must be >= 1, got {order}")

    def bn(g: dict) -> dict:
        out = {k: dt * x for k, x in g.items()}
        term = g
        fac = dt
        for _ in range(2, order + 1):
            term = laplacian(term, None, homogeneous=True)
            fac = fac * dt * coeff
            out = {k: out[k] + fac * term[k] for k in out}
        return out

    return bn
