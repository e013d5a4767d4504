"""Interpolation (E) and spreading (H) through regularized delta windows.

Counterpart of ``petibm_tpu/ibm/interp.py`` (the factor engine,
interp.py:38-161, ``dense_ebnh_blocks`` :314 and ``make_delta_op`` :337;
reference: createdelta.cpp:28-208, decoupledibpm.cpp:149-216).  The
tensor-product delta is kept separated as per-direction banded factor
matrices S_d of shape (nPts, n_d), each row holding one Lagrangian point's
1D kernel weights on its ±w gridline window.  Then

  interpolation (2D):  E u = sum_x ( (S_y^vol @ u) * S_x^vol )
  spreading (2D):      H f = (S_y^delta * f)^T @ S_x^delta

as dense matmuls.  The windowed gather/scatter engine for bodies above
16 384 points is ROADMAP item 18.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh import StaggeredMesh
from ..types import Field
from .delta import KERNELS

VEL_NAMES = ("u", "v", "w")


class DeltaOp:
    """The factor-matrix delta engine: windows, E and H on tensors."""

    def __init__(self, mesh: StaggeredMesh, kernel: str = "ROMA_ET_AL_1999",
                 *, dtype: torch.dtype, device):
        self.mesh = mesh
        self.dim = mesh.dim
        self.kernel, self.half = KERNELS[kernel]
        self.dtype = dtype
        self.device = device

        def t(arr):
            return torch.as_tensor(np.asarray(arr, np.float64), dtype=dtype,
                                   device=device)

        self.vertex = [t(mesh.coord(Field.VERTEX, d)) for d in range(self.dim)]
        self.L = [float(mesh.max[d] - mesh.min[d]) for d in range(self.dim)]
        self.periodic = mesh.periodic
        self.coord = {c: [t(mesh.coord(Field(c), d)) for d in range(self.dim)]
                      for c in range(self.dim)}
        self.dl = {c: [t(mesh.dl(Field(c), d)) for d in range(self.dim)]
                   for c in range(self.dim)}
        self.n = {c: [mesh.n(Field(c), d) for d in range(self.dim)]
                  for c in range(self.dim)}
        # u-grid dl per direction for the kernel widths
        # (reference: createdelta.cpp:69-77)
        self.width_dl = [t(mesh.dl(Field.U, d)) for d in range(self.dim)]

    # ------------------------------------------------------------------
    def cell_index(self, X: torch.Tensor) -> torch.Tensor:
        """Owning pressure-cell index per point per direction
        (reference: singlebodypoints.cpp:95-120)."""
        cols = [torch.searchsorted(self.vertex[d], X[:, d].contiguous(),
                                   right=True) - 1
                for d in range(self.dim)]
        return torch.stack(cols, dim=1)

    def windows(self, X) -> dict:
        """Banded factor matrices for all components:
        {c: {"sd": [per-dir (N, n_d)], "sv": [per-dir (N, n_d)]}}; sd holds
        the 1D delta weights, sv additionally the component cell widths
        (prod over directions of sv = delta * cell volume, the E scaling)."""
        X = torch.as_tensor(X, dtype=self.dtype, device=self.device)
        ijk = self.cell_index(X)
        offsets = torch.arange(-self.half, self.half + 1, device=self.device)
        # kernel widths from the u-grid cell of the first body point
        # (reference: createdelta.cpp:69-77, assumes a uniform region);
        # index_select keeps the index on the device: a moving body's
        # windows, recomputed every step, read nothing on the host
        widths = [self.width_dl[d].index_select(0, ijk[:1, d])
                  for d in range(self.dim)]

        out = {}
        for c in range(self.dim):
            sd_d, sv_d = [], []
            for d in range(self.dim):
                n = self.n[c][d]
                s = ijk[:, d:d + 1] + offsets[None, :]  # (N, K)
                if self.periodic[d]:
                    idx = torch.remainder(s, n)
                    shift = (torch.div(s, n, rounding_mode="floor")
                             .to(self.dtype) * self.L[d])
                    x = self.coord[c][d][idx] + shift
                    valid = torch.ones_like(s, dtype=torch.bool)
                else:
                    valid = (s >= 0) & (s < n)
                    idx = torch.clamp(s, 0, n - 1)
                    x = self.coord[c][d][idx]
                w = self.kernel(X[:, d:d + 1] - x, widths[d])
                w = torch.where(valid, w, torch.zeros_like(w))
                # the K window weights into banded (N, n) rows
                sd = torch.zeros((X.shape[0], n), dtype=self.dtype,
                                 device=self.device).scatter_add_(1, idx, w)
                sd_d.append(sd)
                sv_d.append(sd * self.dl[c][d][None, :])
            out[c] = {"sd": sd_d, "sv": sv_d}
        return out

    # ------------------------------------------------------------------
    def interpolate(self, q: dict, win: dict) -> torch.Tensor:
        """E u: volume-weighted interpolation onto the Lagrangian points;
        returns (N, dim)."""
        cols = []
        for c in range(self.dim):
            w = win[c]
            arr = q[VEL_NAMES[c]]
            if self.dim == 2:
                t = torch.matmul(w["sv"][1], arr)
            else:
                t = torch.einsum("pz,zyx->pyx", w["sv"][2], arr)
                t = torch.einsum("py,pyx->px", w["sv"][1], t)
            cols.append(torch.sum(t * w["sv"][0], dim=1))
        return torch.stack(cols, dim=1)

    def spread(self, f: torch.Tensor, win: dict) -> dict:
        """H f = Delta^T f: spread the (N, dim) Lagrangian forces onto the
        grids; returns a velocity-space dict."""
        out = {}
        for c in range(self.dim):
            w = win[c]
            fc = f[:, c]
            if self.dim == 2:
                out[VEL_NAMES[c]] = torch.matmul(
                    (w["sd"][1] * fc[:, None]).T, w["sd"][0])
            else:
                t = torch.einsum("pz,py->pzy", w["sd"][2] * fc[:, None],
                                 w["sd"][1])
                out[VEL_NAMES[c]] = torch.einsum("pzy,px->zyx", t, w["sd"][0])
        return out


def dense_ebnh_blocks(win: dict, dim: int, dt: float) -> list:
    """Per-component dense (N, N) blocks of E B1 H = dt * E H for factor
    windows: the product over directions of S_vol,d @ S_delta,d^T
    (reference assembles it sparsely, decoupledibpm.cpp:171-216)."""
    mats = []
    for c in range(dim):
        m = None
        for d in range(dim):
            a = torch.matmul(win[c]["sv"][d], win[c]["sd"][d].T)
            m = a if m is None else m * a
        mats.append(dt * m)
    return mats


#: factor-matrix engine up to this many Lagrangian points (the JAX
#: package switches to its windowed engine above)
WINDOWED_THRESHOLD = 16384


def make_delta_op(mesh: StaggeredMesh, kernel: str = "ROMA_ET_AL_1999", *,
                  dtype: torch.dtype, device, n_pts: int | None = None,
                  engine: str = "auto") -> DeltaOp:
    """The factor-matrix delta engine; ``auto`` picks it up to
    WINDOWED_THRESHOLD points, as the JAX package does."""
    if engine == "auto":
        engine = ("windowed" if n_pts is not None
                  and n_pts > WINDOWED_THRESHOLD else "factor")
    if engine == "windowed":
        raise NotImplementedError(
            "the windowed delta engine (bodies above "
            f"{WINDOWED_THRESHOLD} points or deltaEngine: windowed) is not "
            "ported yet (ROADMAP item 18)")
    if engine == "factor":
        return DeltaOp(mesh, kernel, dtype=dtype, device=device)
    raise ValueError(f"unknown delta engine {engine!r} "
                     "(want auto|factor|windowed)")
