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

On a decomposed run (``set_mesh``; JAX ``mg.py:361-400``) each rank holds
its block of every level above ``consolidate_below`` cells
(``parallel.dist.LevelBlocks``: a coarse cell lives with its first
child).  Couplings across a cut take a width-1 halo; restriction and
prolongation move at most one slab along each cut axis.  A sweep along a
cut direction folds the couplings of the cut and split directions into
its right side on the block (K5's form, JAX ``mg.py:259-268``: their
factors go to the kernel as zeros), moves the lines whole onto the ranks
(``to_pencil``, one all-to-all; x and z lines split along y, y lines
along x), runs K4/K5 or K6/K7 there and moves back.  A 3-axis mesh
cuts z as the others cut x and y.  The restricted residual of the first
level at or below the threshold (or the first whose blocks or pencils
would thin below a line: the layout only, not the arithmetic) is
gathered once, and every rank runs the coarser levels whole.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..types import Field
from ..utils import stamps
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
        ``scale``: dt factor of B1; ``consolidate_below``: on a decomposed
        run (``set_mesh``) the levels of at most this many cells run whole
        on every rank; ``kernels``: False runs the twins of K4-K7 on the
        card."""
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
        #: the decomposed run's pressure ``Partition``, the blocks of each
        #: decomposed level and those levels' factors cut to the block
        self.part = None
        self.blocks: list = []
        self._block_levels: list = []
        self._pencils: dict = {}

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

    def set_mesh(self, part) -> None:
        """Decompose the hierarchy over ``part``'s process mesh: levels
        keep their blocks while they hold more than ``consolidate_below``
        cells and ``LevelBlocks.holds_lines``; the rest run whole."""
        from ..parallel.dist import LevelBlocks

        self.part = part
        self.blocks, self._block_levels, self._pencils = [], [], {}
        lb = LevelBlocks.of_pressure(part)
        for lvl, level in enumerate(self.levels):
            if lvl:
                lb = lb.coarsen()
            if (math.prod(level.shape) <= self.consolidate_below
                    or not lb.holds_lines()):
                break
            self.blocks.append(lb)
            self._block_levels.append(self._sub_level(
                lvl, [lb.range(d) for d in range(self.dim)],
                [level.periodic[d] and not lb.cut(d)
                 for d in range(self.dim)]))

    def _sub_level(self, lvl: int, ranges: list, periodic: list) -> Level:
        """Level ``lvl``'s factors cut to the cells ``ranges`` ([lo, hi)
        per direction)."""
        level = self.levels[lvl]
        return Level(
            shape=tuple(hi - lo for lo, hi in reversed(ranges)),
            c1d=[c[lo:hi + 1].contiguous()
                 for c, (lo, hi) in zip(level.c1d, ranges)],
            w1d=[w[lo:hi].contiguous()
                 for w, (lo, hi) in zip(level.w1d, ranges)],
            periodic=list(periodic))

    def _pencil_level(self, lvl: int, d: int) -> Level:
        """Level ``lvl``'s factors on this rank's pencil of direction-d
        lines."""
        key = (lvl, d)
        if key not in self._pencils:
            lb = self.blocks[lvl]
            s = lb.split_dir(d)
            ranges = [(0, self.levels[lvl].shape[self.dim - 1 - e]) if e == d
                      else lb.pencil_range(d) if e == s else lb.range(e)
                      for e in range(self.dim)]
            self._pencils[key] = self._sub_level(
                lvl, ranges, [self.levels[lvl].periodic[e] and e == d
                              for e in range(self.dim)])
        return self._pencils[key]

    # ------------------------------------------------------------------
    def _coupling(self, lvl: int, phi, d: int):
        """Direction-d off-diagonal action: sum of face-coeff * neighbour
        (positive sign), including the periodic wrap."""
        return self._coupling_on(self.levels[lvl], phi, d)

    def _coupling_on(self, level: Level, phi, d: int):
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
        sweep = self._block_sweep if lvl < len(self.blocks) else \
            self._line_sweep
        for _ in range(sweeps):
            for d in range(self.dim):
                phi = sweep(lvl, phi, rhs, d)
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
        return self._line_system_on(self.levels[lvl], d)

    def _line_system_on(self, level: Level, d: int) -> tuple:
        key = ("pcr", d)
        if key not in level._memo:
            axis = self.dim - 1 - d
            n = level.shape[axis]
            area = level.area(d)
            c = level.c1d[d].reshape(level.bshape(d, n + 1))
            cin = c.narrow(axis, 1, n - 1)
            dl = -_pad(cin, axis, 1, 0) * area
            du = -_pad(cin, axis, 0, 1) * area
            level._memo[key] = tuple(
                t.expand(level.shape).contiguous()
                for t in (dl, level.diag_full(), du))
        return level._memo[key]

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
        b = rhs
        for dp in range(self.dim):
            if dp != d:
                b = b + self._coupling(lvl, phi, dp)
        return self._pcr_sweep(level, phi, b, d)

    def _pcr_sweep(self, level: Level, phi, b, d: int):
        """The periodic level's sweep from the off-line right side ``b``:
        this direction's wrap, the line solve (K6/K7) and the damped
        update."""
        axis = self.dim - 1 - d
        n = phi.shape[axis]
        if level.periodic[d]:
            c = level.c1d[d].reshape(level.bshape(d, n + 1))
            into_first, into_last = self._wrap(c, phi, axis)
            b = b + level.area(d) * (into_first + into_last)
        dl, diag, du = self._line_system_on(level, d)
        solve = pcr if self.kernels else pcr_ref
        phi_star = solve(dl, diag, du, b, axis)
        return phi + self.omega * (phi_star - phi)

    # --- the decomposed levels -----------------------------------------
    def _block_coupling(self, lvl: int, phi, d: int):
        """``_coupling`` on the rank's block of level ``lvl``: across a
        cut the neighbours' slabs (the halo, wrapping on a periodic
        axis) stand beside the block."""
        lb, level = self.blocks[lvl], self._block_levels[lvl]
        if not lb.cut(d):
            return self._coupling_on(level, phi, d)
        axis = self.dim - 1 - d
        n = phi.shape[axis]
        lo, hi = lb.halo(phi, d)
        shape = list(phi.shape)
        shape[axis] = 1
        zero = phi.new_zeros(shape)
        below = torch.cat([zero if lo is None else lo,
                           phi.narrow(axis, 0, n - 1)], dim=axis)
        above = torch.cat([phi.narrow(axis, 1, n - 1),
                           zero if hi is None else hi], dim=axis)
        c = level.c1d[d].reshape(level.bshape(d, n + 1))
        out = c.narrow(axis, 0, n) * below + c.narrow(axis, 1, n) * above
        return level.area(d) * out

    def _block_apply(self, lvl: int, phi):
        out = self._block_levels[lvl].diag_full() * phi
        for d in range(self.dim):
            out = out - self._block_coupling(lvl, phi, d)
        return out

    def folded_aux(self, level: Level, d: int, fold: tuple) -> list:
        """``sweep_aux`` of ``level`` with the coupling factors of the
        directions in ``fold`` zeroed: their couplings are in the right
        side already."""
        key = ("aux", d, fold)
        if key not in level._memo:
            aux = [a.to(self.device)
                   for a in sweep_aux(level, d, self.dtype)]
            others = [e for e in range(self.dim) if e != d]
            for j, e in enumerate(others):
                if e in fold:
                    aux[6 + 3 * j] = torch.zeros_like(aux[6 + 3 * j])
                    aux[7 + 3 * j] = torch.zeros_like(aux[7 + 3 * j])
            level._memo[key] = aux
        return level._memo[key]

    def sweep_layout(self, lvl: int, d: int) -> tuple:
        """(the factors of the tensor a direction-d sweep of decomposed
        level ``lvl`` solves on: the rank's pencil where d is cut, else
        its block; the directions whose couplings go to the right side
        on the block).  K4/K5 takes ``folded_aux(level, d, fold)``."""
        lb = self.blocks[lvl]
        periodic = any(self.levels[lvl].periodic)
        split = lb.split_dir(d) if lb.cut(d) else None
        fold = tuple(e for e in range(self.dim) if e != d
                     and (periodic or lb.cut(e) or e == split))
        level = (self._pencil_level(lvl, d) if lb.cut(d)
                 else self._block_levels[lvl])
        return level, fold

    def _block_sweep(self, lvl: int, phi, rhs, d: int):
        """One sweep along direction d on the rank's block of a
        decomposed level: the couplings of the cut directions (and of the
        pencil's split direction) into the right side on the block, the
        lines moved whole onto the ranks where d is cut, the sweep there
        (K4/K5, or K6/K7 on a periodic level), and back."""
        lb = self.blocks[lvl]
        axis = self.dim - 1 - d
        cut = lb.cut(d)
        periodic = any(self.levels[lvl].periodic)
        level, fold = self.sweep_layout(lvl, d)
        b = rhs
        for e in fold:
            b = b + self._block_coupling(lvl, phi, e)
        if cut:
            phi, b = lb.to_pencil(d, phi, b)
        if periodic:
            out = self._pcr_sweep(level, phi, b, d)
        else:
            sweep = fused_sweep if self.kernels else fused_sweep_ref
            out = sweep(phi, b, self.folded_aux(level, d, fold), axis,
                        self.omega)
        return lb.from_pencil(d, out)[0] if cut else out

    def _block_restrict(self, lvl: int, r):
        """``restrict`` from the rank's block of level ``lvl`` to its block
        of level lvl + 1: a block that ends on a first child takes the
        second from its upper neighbour."""
        lb = self.blocks[lvl]
        out = r
        for d in range(self.dim):
            axis = self.dim - 1 - d
            lo, hi = lb.range(d)
            n = self.levels[lvl].shape[axis]
            if lb.cut(d):
                _, above = lb.halo(out, d, lower=False)
                out = out.narrow(axis, lo % 2, out.shape[axis] - lo % 2)
                if hi % 2 and hi < n:
                    out = torch.cat([out, above], dim=axis)
            m = out.shape[axis]
            out = _pad(out, axis, 0, m % 2)
            new_shape = list(out.shape)
            new_shape[axis] = (m + 1) // 2
            new_shape.insert(axis + 1, 2)
            out = out.reshape(new_shape).sum(dim=axis + 1)
        return out

    def _block_prolong(self, lvl: int, e):
        """``prolong`` onto the rank's block of level ``lvl`` from its
        block of level lvl + 1 (or from the whole of a consolidated level
        lvl + 1): a block that starts on a second child takes its parent
        from the lower neighbour."""
        lb = self.blocks[lvl]
        whole = lvl + 1 >= len(self.blocks)
        out = e
        for d in range(self.dim):
            axis = self.dim - 1 - d
            lo, hi = lb.range(d)
            if whole:
                out = out.narrow(axis, lo // 2, (hi - 1) // 2 - lo // 2 + 1)
            elif lb.cut(d):
                below, _ = lb.halo(out, d, upper=False)
                if lo % 2:
                    out = torch.cat([below, out], dim=axis)
            out = torch.repeat_interleave(out, 2, dim=axis)
            out = out.narrow(axis, lo % 2, hi - lo)
        return out

    def _block_vcycle(self, lvl: int, rhs):
        """``vcycle`` on the rank's block of a decomposed level."""
        lb = self.blocks[lvl]
        phi = torch.zeros(lb.local_shape(), dtype=self.dtype,
                          device=self.device)
        if lvl == len(self.levels) - 1:
            return self.smooth(lvl, phi, rhs, self.coarse_sweeps)
        phi = self.smooth(lvl, phi, rhs, self.pre)
        r = rhs - self._block_apply(lvl, phi)
        rc = self._block_restrict(lvl, r)
        if lvl + 1 < len(self.blocks):
            ec = self._block_vcycle(lvl + 1, rc)
        else:
            # consolidation: the coarse residual gathered once, the
            # coarser levels run whole on every rank
            ec = self.vcycle(lvl + 1, lb.coarsen().gather(rc))
        phi = phi + self._block_prolong(lvl, ec)
        return self.smooth(lvl, phi, rhs, self.post)

    def cycle(self, r):
        """One V-cycle from level 0 on the rank's tensor: the whole field,
        or the rank's pressure block of a decomposed run (a level 0 at or
        below the threshold gathered, cycled whole and cut back).  A
        traced step stamps its device time and count
        (``utils/stamps.py``)."""
        with stamps.region("vcycle"):
            if self.part is None:
                return self.vcycle(0, r)
            if self.blocks:
                return self._block_vcycle(0, r)
            full = self.vcycle(0, self.part.gather(r, Field.P))
            return full[self.part.block(Field.P)].contiguous()

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
            return self.cycle
        mean = torch.mean if self.part is None else self.part.mean

        def M(r):
            out = self.cycle(r - mean(r))
            return out - mean(out)

        return M

    def sweeps_per_vcycle(self) -> int:
        """Line sweeps (kernel launches) of one V-cycle:
        sum_{l < L-1} D (pre + post) + D coarse_sweeps."""
        nlev = len(self.levels)
        return self.dim * ((nlev - 1) * (self.pre + self.post)
                           + self.coarse_sweeps)
