"""Level-0 separable factors of the pressure Poisson operator.

Counterpart of the finest level of ``petibm_tpu/linalg/mg.py`` (``_Level``
and ``PoissonMG._make_level``, mg.py:43-66, 128-136, 161-166).  The JAX
flagship builds a whole multigrid hierarchy only to obtain these factors
for the fused Poisson apply; the port builds level 0 directly.  The
V-cycle itself belongs to a later slice (ROADMAP item 15).

The negated FV operator -D B1 G is separable: the face coefficient of
direction d is ``c1d[d] x prod_{e != d} w1d[e]``, where

  c1d[d]: (n_d + 1,) scaled face coefficients scale/dist; entry k couples
          cells k-1 and k; 0 at non-periodic walls, the wrap coefficient
          at entries 0 and n for periodic directions
  w1d[d]: (n_d,) cell widths (the perpendicular-area factors)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Level:
    shape: tuple  # (z, y, x) ordering
    c1d: list     # per direction (x, y[, z]): (n_d + 1,) tensors
    w1d: list     # per direction: (n_d,) tensors
    periodic: list

    def bshape(self, d: int, n: int) -> list:
        """Broadcast shape putting ``n`` entries on direction d's axis."""
        s = [1] * len(self.shape)
        s[len(self.shape) - 1 - d] = n
        return s


def face_coefficients(widths: np.ndarray, periodic: bool) -> np.ndarray:
    """Unscaled 1/dist face coefficients of one direction (float64)."""
    w = np.asarray(widths, np.float64)
    c = np.zeros(len(w) + 1)
    c[1:-1] = 1.0 / (0.5 * (w[:-1] + w[1:]))
    if periodic:
        c[0] = c[-1] = 1.0 / (0.5 * (w[0] + w[-1]))
    return c


def poisson_level0(dxp: list, periodic: list, *, dtype: torch.dtype,
                   device, scale: float = 1.0) -> Level:
    """Finest-level factors for pressure cell widths ``dxp`` (x, y[, z])
    and the dt factor ``scale`` of B1."""
    widths = [np.asarray(d, np.float64) for d in dxp]
    return Level(
        shape=tuple(reversed([len(w) for w in widths])),
        c1d=[torch.as_tensor(scale * face_coefficients(w, p), dtype=dtype,
                             device=device)
             for w, p in zip(widths, periodic)],
        w1d=[torch.as_tensor(w, dtype=dtype, device=device) for w in widths],
        periodic=list(periodic))
