"""Geometric multigrid for the pressure Poisson system.

Counterpart of ``petibm_tpu/linalg/mg.py`` (single device): the V-cycle
preconditioner of CG on the negated pressure operator, the port of the
reference's ``-poisson_pc_type gamg`` configuration.

The negated FV operator -D B1 G is separable: the face coefficient of
direction d is ``c1d[d] x prod_{e != d} w1d[e]``, where

  c1d[d]: (n_d + 1,) scaled face coefficients scale/dist; entry k couples
          cells k-1 and k; 0 at non-periodic walls, the wrap coefficient
          at entries 0 and n for periodic directions
  w1d[d]: (n_d,) cell widths (the perpendicular-area factors)

Coarser levels are the Galerkin (RAP) operators of child-sum restriction
and injection prolongation, which stay separable: coarse widths are
pairwise sums (an odd tail keeps a lone cell) and coarse face coefficients
are the fine ones at the coarse faces.  The smoother is alternating-
direction damped line-Jacobi.  On a level with no periodic axis one sweep
is the fused kernel K4/K5 (``cuda_sweep.py``); on a level with any periodic
axis the sweep builds the line systems densely (the wrap Jacobi-lagged
into the right side) and solves them with the PCR kernel K6/K7
(``cuda_pcr.py``).  CPU tensors, or ``kernels=False`` (the solvers'
``parameters.disablePallas``), run the kernels' plain twins along the same
dispatch.

``poisson_level0`` builds level 0 alone, for the solvers' direct (FDM)
pressure path, whose residual operator needs only its factors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .cuda_pcr import pcr, pcr_ref
from .cuda_sweep import fused_sweep, fused_sweep_ref, sweep_aux


@dataclasses.dataclass
class Level:
    shape: tuple  # (z, y, x) ordering
    c1d: list     # per direction (x, y[, z]): (n_d + 1,) tensors
    w1d: list     # per direction: (n_d,) tensors
    periodic: list
    # areas and the full diagonal, formed on first use (constant factors)
    _memo: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)

    def bshape(self, d: int, n: int) -> list:
        """Broadcast shape putting ``n`` entries on direction d's axis."""
        s = [1] * len(self.shape)
        s[len(self.shape) - 1 - d] = n
        return s

    def area(self, d: int) -> torch.Tensor:
        """Perpendicular area: broadcastable product of the other
        directions' cell widths (constant along direction d)."""
        key = ("area", d)
        if key not in self._memo:
            out = None
            for dp, w in enumerate(self.w1d):
                if dp == d:
                    continue
                t = w.reshape(self.bshape(dp, w.shape[0]))
                out = t if out is None else out * t
            if out is None:  # 1D operator
                out = torch.ones((1,) * len(self.shape),
                                 dtype=self.c1d[0].dtype,
                                 device=self.c1d[0].device)
            self._memo[key] = out
        return self._memo[key]

    def coeff(self, d: int) -> torch.Tensor:
        """Dense-value face coefficient array of direction d."""
        c = self.c1d[d].reshape(self.bshape(d, self.c1d[d].shape[0]))
        return c * self.area(d)

    def diag_full(self) -> torch.Tensor:
        """Row diagonal (positive sum of face coefficients), broadcast to
        the level shape."""
        if "diag" not in self._memo:
            out = None
            for d, c in enumerate(self.c1d):
                a = (c[:-1] + c[1:]).reshape(self.bshape(d, c.shape[0] - 1))
                t = a * self.area(d)
                out = t if out is None else out + t
            self._memo["diag"] = out.expand(self.shape)
        return self._memo["diag"]


def face_coefficients(widths: np.ndarray, periodic: bool) -> np.ndarray:
    """Unscaled 1/dist face coefficients of one direction (float64)."""
    w = np.asarray(widths, np.float64)
    c = np.zeros(len(w) + 1)
    c[1:-1] = 1.0 / (0.5 * (w[:-1] + w[1:]))
    if periodic:
        c[0] = c[-1] = 1.0 / (0.5 * (w[0] + w[-1]))
    return c


def _make_level(widths, inv_dist, periodic, scale, dtype, device) -> Level:
    return Level(
        shape=tuple(reversed([len(w) for w in widths])),
        c1d=[torch.as_tensor(scale * c, dtype=dtype, device=device)
             for c in inv_dist],
        w1d=[torch.as_tensor(w, dtype=dtype, device=device) for w in widths],
        periodic=list(periodic))


def poisson_level0(dxp: list, periodic: list, *, dtype: torch.dtype,
                   device, scale: float = 1.0) -> Level:
    """Finest-level factors for pressure cell widths ``dxp`` (x, y[, z])
    and the dt factor ``scale`` of B1 (equal to ``PoissonMG(...).levels[0]``)."""
    widths = [np.asarray(d, np.float64) for d in dxp]
    return _make_level(widths, [face_coefficients(w, p)
                                for w, p in zip(widths, periodic)],
                       periodic, scale, dtype, device)


def _pad(x: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """Zero padding of ``lo`` and ``hi`` entries along ``axis``."""
    return F.pad(x, [0, 0] * (x.ndim - 1 - axis) + [lo, hi])


class PoissonMG:
    """V-cycle preconditioner for the negated pressure Poisson operator."""

    def __init__(self, dxp: list, periodic: list, *, dtype: torch.dtype,
                 device, scale: float = 1.0, pre: int = 2, post: int = 2,
                 omega: float = 1.0, coarse_sweeps: int = 10,
                 min_size: int = 3, consolidate_below: int = 4096,
                 kernels: bool = True):
        """``dxp``: pressure cell widths per direction (x, y[, z]);
        ``scale``: dt factor of B1; ``consolidate_below``: the coarse-level
        consolidation threshold of sharded runs, accepted and unused on one
        device; ``kernels``: False runs the twins of K4-K7 on the card."""
        self.dim = len(dxp)
        self.dtype = dtype
        self.device = torch.device(device)
        self.pre, self.post = pre, post
        self.omega = omega
        self.coarse_sweeps = coarse_sweeps
        self.consolidate_below = int(consolidate_below)
        self.kernels = kernels
        self._fused_apply0 = None
        self._sweep_aux_cache: dict = {}

        widths = [np.asarray(d, np.float64) for d in dxp]
        inv_dist = [face_coefficients(w, p) for w, p in zip(widths, periodic)]
        # Galerkin hierarchy: coarse interface coefficient = fine 1/dist at
        # the interface face times the coarse perpendicular area
        self.levels: list[Level] = []
        while True:
            self.levels.append(_make_level(widths, inv_dist, periodic, scale,
                                           dtype, self.device))
            if min(len(w) for w in widths) <= min_size or len(self.levels) > 12:
                break
            new_w, new_c = [], []
            for w, c in zip(widths, inv_dist):
                n = len(w)
                nc = (n + 1) // 2
                wc = np.zeros(nc)
                wc[: n // 2] = w[0:2 * (n // 2):2] + w[1:2 * (n // 2):2]
                if n % 2:
                    wc[-1] = w[-1]
                new_w.append(wc)
                new_c.append(c[np.minimum(2 * np.arange(nc + 1), n)])
            widths, inv_dist = new_w, new_c

    def set_mesh(self, mesh) -> None:
        raise NotImplementedError("the multigrid V-cycle on a decomposed "
                                  "run is not ported yet (ROADMAP item 19b)")

    # ------------------------------------------------------------------
    def _coupling(self, lvl: int, phi, d: int):
        """Direction-d off-diagonal action: sum of face-coeff * neighbour
        (positive sign), including the periodic wrap."""
        level = self.levels[lvl]
        axis = self.dim - 1 - d
        n = phi.shape[axis]
        c = level.c1d[d].reshape(level.bshape(d, n + 1))
        lo = phi.narrow(axis, 0, n - 1)
        hi = phi.narrow(axis, 1, n - 1)
        cin = c.narrow(axis, 1, n - 1)
        # interior faces couple (k-1, k): row k gets c(k)*phi(k-1), row
        # k-1 gets c(k)*phi(k)
        out = _pad(cin * lo, axis, 1, 0)
        out = out + _pad(cin * hi, axis, 0, 1)
        if level.periodic[d]:
            into_first, into_last = self._wrap(c, phi, axis)
            out = out + into_first + into_last
        return level.area(d) * out

    @staticmethod
    def _wrap(c, phi, axis: int) -> tuple:
        """The periodic wrap of one direction: c[0] * phi[last] into the
        first row and c[0] * phi[first] into the last, as two terms."""
        n = phi.shape[axis]
        c0 = c.narrow(axis, 0, 1)
        first = phi.narrow(axis, 0, 1)
        last = phi.narrow(axis, n - 1, 1)
        return (_pad(c0 * last, axis, 0, n - 1),
                _pad(c0 * first, axis, n - 1, 0))

    def set_fused_apply(self, fn) -> None:
        """Route the finest-level operator through a kernel (K1 or K2b):
        the V-cycle's level-0 residual."""
        self._fused_apply0 = fn

    def apply_op(self, lvl: int, phi):
        """The negated FV Laplacian at one level: positive semidefinite."""
        if lvl == 0 and self._fused_apply0 is not None:
            return self._fused_apply0(phi)
        out = self.levels[lvl].diag_full() * phi
        for d in range(self.dim):
            out = out - self._coupling(lvl, phi, d)
        return out

    def smooth(self, lvl: int, phi, rhs, sweeps: int):
        """Alternating-direction damped line-Jacobi: each sweep solves the
        tridiagonal line systems of each direction in turn."""
        for _ in range(sweeps):
            for d in range(self.dim):
                phi = self._line_sweep(lvl, phi, rhs, d)
        return phi

    def _aux(self, lvl: int, d: int) -> list:
        key = (lvl, d)
        if key not in self._sweep_aux_cache:
            self._sweep_aux_cache[key] = [
                a.to(self.device)
                for a in sweep_aux(self.levels[lvl], d, self.dtype)]
        return self._sweep_aux_cache[key]

    def _line_system(self, lvl: int, d: int) -> tuple:
        """The dense (dl, diag, du) of direction d's line systems on a
        level with a periodic axis: diag = the full diagonal, off-diagonals
        -c_in * area (dl[k] couples to k-1, du[k] to k+1); constant, so
        formed once."""
        key = ("pcr", lvl, d)
        if key not in self._sweep_aux_cache:
            level = self.levels[lvl]
            axis = self.dim - 1 - d
            n = level.shape[axis]
            area = level.area(d)
            c = level.c1d[d].reshape(level.bshape(d, n + 1))
            cin = c.narrow(axis, 1, n - 1)
            dl = -_pad(cin, axis, 1, 0) * area
            du = -_pad(cin, axis, 0, 1) * area
            self._sweep_aux_cache[key] = tuple(
                t.expand(level.shape).contiguous()
                for t in (dl, level.diag_full(), du))
        return self._sweep_aux_cache[key]

    def _line_sweep(self, lvl: int, phi, rhs, d: int):
        level = self.levels[lvl]
        axis = self.dim - 1 - d
        if not any(level.periodic):
            # the fused sweep: couplings, rescaled PCR and damped update in
            # one kernel (K4/K5)
            sweep = fused_sweep if self.kernels else fused_sweep_ref
            return sweep(phi, rhs, self._aux(lvl, d), axis, self.omega)
        # a level with a periodic axis: off-line couplings (other
        # directions, and this direction's wrap, Jacobi-lagged) to the RHS
        n = phi.shape[axis]
        b = rhs
        for dp in range(self.dim):
            if dp != d:
                b = b + self._coupling(lvl, phi, dp)
        area = level.area(d)
        c = level.c1d[d].reshape(level.bshape(d, n + 1))
        if level.periodic[d]:
            into_first, into_last = self._wrap(c, phi, axis)
            b = b + area * (into_first + into_last)
        dl, diag, du = self._line_system(lvl, d)
        solve = pcr if self.kernels else pcr_ref
        phi_star = solve(dl, diag, du, b, axis)
        return phi + self.omega * (phi_star - phi)

    def restrict(self, lvl: int, r):
        """Conservative child-sum onto level lvl+1."""
        coarse_shape = self.levels[lvl + 1].shape
        out = r
        for d in range(self.dim):
            axis = self.dim - 1 - d
            n = out.shape[axis]
            nc = coarse_shape[axis]
            padded = _pad(out, axis, 0, 2 * nc - n)
            new_shape = list(padded.shape)
            new_shape[axis] = nc
            new_shape.insert(axis + 1, 2)
            out = padded.reshape(new_shape).sum(dim=axis + 1)
        return out

    def prolong(self, lvl: int, e):
        """Piecewise-constant injection onto level lvl-1."""
        fine_shape = self.levels[lvl - 1].shape
        out = e
        for d in range(self.dim):
            axis = self.dim - 1 - d
            out = torch.repeat_interleave(out, 2, dim=axis)
            out = out.narrow(axis, 0, fine_shape[axis])
        return out

    def vcycle(self, lvl: int, rhs):
        """One V-cycle solving (apply_op) e = rhs from a zero initial guess."""
        phi = torch.zeros(self.levels[lvl].shape, dtype=self.dtype,
                          device=self.device)
        if lvl == len(self.levels) - 1:
            return self.smooth(lvl, phi, rhs, self.coarse_sweeps)
        phi = self.smooth(lvl, phi, rhs, self.pre)
        r = rhs - self.apply_op(lvl, phi)
        ec = self.vcycle(lvl + 1, self.restrict(lvl, r))
        phi = phi + self.prolong(lvl + 1, ec)
        return self.smooth(lvl, phi, rhs, self.post)

    def preconditioner(self, remove_mean: bool = True):
        """M(r) ~ A^-1 r via one V-cycle (for CG on the negated operator).
        ``remove_mean`` keeps the Krylov space orthogonal to the all-Neumann
        operator's constant nullspace."""
        if not remove_mean:
            return lambda r: self.vcycle(0, r)

        def M(r):
            out = self.vcycle(0, r - torch.mean(r))
            return out - torch.mean(out)

        return M

    def sweeps_per_vcycle(self) -> int:
        """Line sweeps (kernel launches) of one V-cycle:
        sum_{l < L-1} D (pre + post) + D coarse_sweeps."""
        nlev = len(self.levels)
        return self.dim * ((nlev - 1) * (self.pre + self.post)
                           + self.coarse_sweeps)
