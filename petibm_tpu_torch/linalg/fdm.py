"""Direct fast-diagonalization solvers (eigenvector and FFT transforms).

Counterpart of ``petibm_tpu/linalg/fdm.py`` (fdm.py:203-596), single
device.  For BN order 1 the pressure operator -D B1 G, and the BC-folded
momentum Helmholtz operator I/dt - c_imp*nu*L of each velocity component,
are exact Kronecker sums of 1D operators T_d.  At setup each direction's
generalized symmetric eigenproblem is solved in host numpy float64; a
solve is then a transform per direction, a pointwise divide by the
eigenvalue sum, and the back-transform.  A direction's transform is a
dense product (``torch.matmul`` in the working dtype, full float32 on the
card: TF32 stays off), or, with ``use_fft`` on a periodic uniformly spaced
direction, whose eigenbasis is the Fourier basis, ``torch.fft.rfftn`` /
``irfftn`` with the analytic symbol (JAX ``fdm.py:259-378``; cuFFT on the
card, where JAX has XLA's FFT: no Pallas kernel on either side).

``make_fdm_solver`` wraps a direct solve in KSP stopping semantics: a
warm-started direct pass, then refinement passes judged on the recurrence
residual with a stagnation exit.  The passes are one loop body on the
current driver of ``loops.py``: its predicate is formed on the device.

``pinned_operator`` and ``PinnedSolve`` give the pinned pressure of the
reference's GPU backend (row and column 0 of the pressure block the
identity): its operator, and its exact inverse from a projected solve
(the FDM pressure solve, or the coupled IBPM's Schur solve).

Decomposed over a process group (``set_mesh``), a solve takes one of
two cores, as the JAX package chooses (``fdm.py:342, 494``,
``navierstokes.py:325-328, 495-500``):

- on a 2-axis mesh with ``fdm.repartition`` (the default) it
  repartitions the blocks with four all-to-alls
  (``_ShardedTransformCore``, JAX ``fdm.py:64-186``): block -> y cut over
  all ranks (the x and z transforms local, an rfft on a periodic x among
  them) -> x cut over all ranks (the y transform, the FFTs on y and z
  and the eigenvalue divide local) -> back;
- on a 3-axis mesh, or with ``fdm.repartition: false``, it keeps the
  blocks (``_ContractionCore``), what GSPMD makes of the JAX package's
  tensordots over sharded axes: a dense transform along a cut axis
  multiplies the block by its own columns of the factor and sums the
  partial results over the axis's ranks (``reduce_scatter``); an FFT
  along a cut axis runs on pencils of whole lines (an all-to-all there
  and back).

Not ported: the ``precision`` knobs of the transforms (full precision of
the working dtype here).
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.dist import LevelBlocks, alltoall
from ..types import Field
from . import loops
from .krylov import SolveResult, _norm, counter, tadd_, tmap, tsub_
from .mg import face_coefficients


def _apply_per_axis(mats: list, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Apply mats[d] along direction d's array axis (dim-1-d); ``mats[d]``
    None skips direction d (its transform is an FFT)."""
    for d in range(dim):
        axis = dim - 1 - d
        m = mats[d]
        if m is None:
            continue
        if axis == x.ndim - 1:
            x = torch.matmul(x, m.T)
        elif axis == x.ndim - 2:
            x = torch.matmul(m, x)
        else:
            x = torch.tensordot(m, x, dims=([1], [axis])).movedim(0, axis)
    return x


def fdm_config(params: dict) -> dict:
    """Normalize ``parameters.fdm`` (bool shorthand or knob dict)."""
    cfg = params.get("fdm", {})
    if cfg is False:
        return {"enabled": False}
    if not isinstance(cfg, dict):
        return {}
    return cfg


def line_operator(widths: np.ndarray, periodic: bool, scale: float) -> np.ndarray:
    """Dense 1D FV operator T_d (float64): face coefficient scale/dist,
    zero flux at non-periodic walls, wraparound where periodic."""
    n = len(widths)
    c = scale * face_coefficients(widths, periodic)
    T = np.zeros((n, n))
    idx = np.arange(n)
    T[idx, idx] = c[:-1] + c[1:]
    T[idx[1:], idx[:-1]] -= c[1:-1]
    T[idx[:-1], idx[1:]] -= c[1:-1]
    if periodic and n > 1:
        T[0, -1] -= c[0]
        T[-1, 0] -= c[0]
    return T


def _uniform_width(widths: np.ndarray, rtol: float = 1e-9) -> float | None:
    """The common cell width when the axis is uniformly spaced, else None
    (a copy of JAX ``fdm.py:203-207``)."""
    w = np.asarray(widths, np.float64)
    h = float(w.mean())
    return h if np.allclose(w, h, rtol=rtol, atol=0.0) else None


def _fft_symbol(n: int, h: float, scale: float) -> np.ndarray:
    """Generalized eigenvalues of the periodic uniform 1D FV Poisson factor
    (circulant T with faces scale/h, weight W = h I) in DFT-frequency
    order: lambda_k = 2*scale*(1 - cos(2 pi k / n)) / h^2 (a copy of JAX
    ``fdm.py:210-216``)."""
    k = np.arange(n)
    return 2.0 * scale * (1.0 - np.cos(2.0 * np.pi * k / n)) / (h * h)


def _lam_sum(lams: list, dim: int, fft_axes: tuple = ()) -> np.ndarray:
    """Kronecker sum of per-direction eigenvalues over the (z, y[, x])
    grid, summed in array-axis order as the JAX package sums it; the
    real-to-complex rfft halves the last of ``fft_axes`` to n//2+1."""
    lams_ax = [np.asarray(lams[dim - 1 - ax]) for ax in range(dim)]
    if fft_axes:
        rax = fft_axes[-1]
        lams_ax[rax] = lams_ax[rax][:len(lams_ax[rax]) // 2 + 1]
    out = np.zeros(tuple(len(lam) for lam in lams_ax))
    for ax, lam in enumerate(lams_ax):
        bshape = [1] * dim
        bshape[ax] = len(lam)
        out = out + lam.reshape(bshape)
    return out


def _fft_solve(b, fwd: list, inv: list, inv_lam, dim: int,
               fft_axes: tuple, fft_sizes: tuple, dtype):
    """One fast-diagonalization solve: the dense transforms first, the
    FFTs innermost (the reverse order on the way back keeps the dense
    products real), the divide, and the way back in ``dtype``."""
    bhat = _apply_per_axis(fwd, b, dim)
    if fft_axes:
        bhat = torch.fft.rfftn(bhat, dim=fft_axes)
    xhat = bhat * inv_lam
    if fft_axes:
        xhat = torch.fft.irfftn(xhat, s=fft_sizes, dim=fft_axes).to(dtype)
    return _apply_per_axis(inv, xhat, dim)


def _dense(mats: list, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``_apply_per_axis`` of real factors; a complex ``x`` (after an FFT)
    takes them on its real and imaginary parts, as a real array would."""
    if not x.is_complex():
        return _apply_per_axis(mats, x, dim)
    return torch.complex(_apply_per_axis(mats, x.real.contiguous(), dim),
                         _apply_per_axis(mats, x.imag.contiguous(), dim))


def _flat(t: torch.Tensor) -> torch.Tensor:
    """A 1D real view of a chunk (complex entries as two reals)."""
    t = t.contiguous()
    return (torch.view_as_real(t) if t.is_complex() else t).reshape(-1)


def _unflat(flat: torch.Tensor, shape: tuple, cplx: bool) -> torch.Tensor:
    if not cplx:
        return flat.reshape(shape)
    return torch.view_as_complex(flat.reshape(shape + (2,)))


def _pad_to(x: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """``x`` zero-padded along ``axis`` to ``n`` entries."""
    extra = n - x.shape[axis]
    if extra == 0:
        return x
    shape = list(x.shape)
    shape[axis] = extra
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


class _ShardedTransformCore:
    """The separable solve on a field decomposed over a process group
    (``parallel.dist.Partition``), the distributed-FFT pattern of JAX
    ``fdm.py:64-186`` with explicit all-to-alls:

        the (dy, dx) blocks -> y cut over all D ranks (all-to-all 1)
        x (and z) transforms local: dense, or the rfft on a periodic x
        y cut -> x cut over all ranks (all-to-all 2)
        y transform and the FFTs on y and z, the eigenvalue divide, and
        back, local
        x cut -> y cut (all-to-all 3); x (and z) back-transforms local
        y cut -> the blocks (all-to-all 4)

    x and y are zero-padded to a multiple of D (x after its rfft, when
    x is an FFT axis), and so are the dense transforms and ``inv_lam``,
    so each rank's cut is D-th of the padded axis and the pad stays
    exactly zero.  Transposes 2 and 3 move equal chunks (complex ones as
    pairs of reals); 1 and 4 move each block's overlap with each cut.
    The JAX package's shard_map core takes FFTs on z only and leaves an
    FFT on x or y to GSPMD; here the FFT of each axis runs where the
    axis is whole, as the single-device ``rfftn`` would (the last FFT
    axis real-to-complex), up to the order of the sums."""

    def __init__(self, part, field, fwd: list, bwd: list,
                 inv_lam: torch.Tensor, fft_axes: tuple, fft_sizes: tuple,
                 dtype: torch.dtype):
        self.part, self.field, self.dtype = part, field, dtype
        self.dim = dim = part.dim
        self.D = D = part.pmesh.size
        self.rank = part.rank
        ax_x, ax_y = dim - 1, dim - 2
        n = [part.mesh.n(field, d) for d in range(dim)]
        self.nx, self.ny = n[0], n[1]
        sizes = dict(zip(fft_axes, fft_sizes))
        #: the rfft on x, in the y-cut phase (x is then the last FFT axis)
        self.x_fft = ax_x in sizes
        #: the FFTs of the x-cut phase: (axes, sizes, real-to-complex?)
        rest = [ax for ax in fft_axes if ax != ax_x]
        self.rest = (tuple(rest), tuple(sizes[ax] for ax in rest),
                     not self.x_fft)
        self.y_fft = ax_y in sizes
        # the x extent while x is cut: px real, or the rfft's nx // 2 + 1
        xw = n[0] // 2 + 1 if self.x_fft else n[0]
        self.sx, self.sy = -(-xw // D), -(-n[1] // D)
        self.px, py = self.sx * D, self.sy * D

        def padmat(m, to):
            if m is None or m.shape[0] == to:
                return m
            out = torch.zeros((to, to), dtype=m.dtype, device=m.device)
            out[:m.shape[0], :m.shape[1]] = m
            return out

        pads = [self.px, py] + n[2:]

        def split(mats):
            """(the x and z factors, the y factor), each a per-direction
            list for ``_apply_per_axis``"""
            mats = [padmat(m, pads[d]) for d, m in enumerate(mats)]
            return ([None if d == 1 else m for d, m in enumerate(mats)],
                    [m if d == 1 else None for d, m in enumerate(mats)])

        self.fwd_xz, self.fwd_y = split(fwd)
        self.bwd_xz, self.bwd_y = split(bwd)
        # the divide in the x-cut layout: y padded where it is dense (an
        # FFT on y takes its ny entries alone), x padded and cut
        lam = _pad_to(inv_lam, ax_x, self.px)
        if not self.y_fft:
            lam = _pad_to(lam, ax_y, py)
        self.inv_lam = lam[..., self.rank * self.sx:
                           (self.rank + 1) * self.sx].contiguous()
        # every rank's block rows and columns
        self.rows = [part.range(field, 1, r) for r in range(D)]
        self.cols = [part.range(field, 0, r) for r in range(D)]
        self.lead = tuple(n[2:][::-1])  # the z extent (3D)

    def _cut_rows(self, r: int) -> tuple:
        return r * self.sy, (r + 1) * self.sy

    def _overlap(self, blk: int, cut: int) -> tuple:
        """Rows of rank ``blk``'s block inside rank ``cut``'s y cut."""
        (y0, y1), (c0, c1) = self.rows[blk], self._cut_rows(cut)
        return max(y0, c0), max(min(y1, c1), max(y0, c0))

    def _to_ycut(self, b: torch.Tensor) -> torch.Tensor:
        """All-to-all 1: my block's rows to each y cut; my cut of the
        (.., sy, nx) layout assembled from every block."""
        me, D = self.rank, self.D
        y0 = self.rows[me][0]
        pieces, send = [], []
        for r in range(D):
            lo, hi = self._overlap(me, r)
            piece = b[..., lo - y0:hi - y0, :].reshape(-1)
            pieces.append(piece)
            send.append(piece.numel())
        recv, shapes = [], []
        for s in range(D):
            lo, hi = self._overlap(s, me)
            x0, x1 = self.cols[s]
            shapes.append((lo, hi, x0, x1))
            recv.append(int(np.prod(self.lead + (hi - lo, x1 - x0))))
        flat = alltoall(torch.cat(pieces), send, recv)
        out = torch.zeros(self.lead + (self.sy, self.nx), dtype=b.dtype,
                          device=b.device)
        c0 = self._cut_rows(me)[0]
        for (lo, hi, x0, x1), chunk in zip(shapes, flat.split(recv)):
            out[..., lo - c0:hi - c0, x0:x1] = chunk.reshape(
                self.lead + (hi - lo, x1 - x0))
        return out

    def _from_ycut(self, x: torch.Tensor) -> torch.Tensor:
        """All-to-all 4, the inverse of ``_to_ycut``."""
        me, D = self.rank, self.D
        c0 = self._cut_rows(me)[0]
        pieces, send = [], []
        for r in range(D):
            lo, hi = self._overlap(r, me)
            x0, x1 = self.cols[r]
            piece = x[..., lo - c0:hi - c0, x0:x1].reshape(-1)
            pieces.append(piece)
            send.append(piece.numel())
        y0, y1 = self.rows[me]
        x0, x1 = self.cols[me]
        recv, spans = [], []
        for s in range(D):
            lo, hi = self._overlap(me, s)
            spans.append((lo, hi))
            recv.append(int(np.prod(self.lead + (hi - lo, x1 - x0))))
        flat = alltoall(torch.cat(pieces), send, recv)
        out = torch.empty(self.lead + (y1 - y0, x1 - x0), dtype=x.dtype,
                          device=x.device)
        for (lo, hi), chunk in zip(spans, flat.split(recv)):
            out[..., lo - y0:hi - y0, :] = chunk.reshape(
                self.lead + (hi - lo, x1 - x0))
        return out

    def _ycut_to_xcut(self, x: torch.Tensor) -> torch.Tensor:
        """All-to-all 2: (.., sy, px) -> (.., py, sx), equal chunks."""
        D, sx = self.D, self.sx
        chunks = [_flat(x[..., :, r * sx:(r + 1) * sx]) for r in range(D)]
        count = chunks[0].numel()
        flat = alltoall(torch.cat(chunks), [count] * D, [count] * D)
        shape = self.lead + (self.sy, sx)
        return torch.cat([_unflat(c, shape, x.is_complex())
                          for c in flat.split(count)], dim=-2)

    def _xcut_to_ycut(self, x: torch.Tensor) -> torch.Tensor:
        """All-to-all 3: (.., py, sx) -> (.., sy, px), equal chunks."""
        D, sy = self.D, self.sy
        chunks = [_flat(x[..., r * sy:(r + 1) * sy, :]) for r in range(D)]
        count = chunks[0].numel()
        flat = alltoall(torch.cat(chunks), [count] * D, [count] * D)
        shape = self.lead + (sy, self.sx)
        return torch.cat([_unflat(c, shape, x.is_complex())
                          for c in flat.split(count)], dim=-1)

    def _xcut_solve(self, x: torch.Tensor) -> torch.Tensor:
        """The x-cut phase: the y transform, the FFTs on y and z, the
        divide, and back."""
        dim, ny = self.dim, self.ny
        axes, sizes, real = self.rest
        x = _dense(self.fwd_y, x, dim)
        if self.y_fft:
            x = x[..., :ny, :]  # the FFT takes y's entries alone
        if axes:
            x = (torch.fft.rfftn(x, dim=axes) if real
                 else torch.fft.fftn(x, dim=axes))
        x = x * self.inv_lam
        if axes:
            x = (torch.fft.irfftn(x, s=sizes, dim=axes).to(self.dtype)
                 if real else torch.fft.ifftn(x, dim=axes))
        if self.y_fft:
            x = _pad_to(x, dim - 2, self.sy * self.D)
        return _dense(self.bwd_y, x, dim)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        dim = self.dim
        x = _dense(self.fwd_xz, _pad_to(self._to_ycut(b), dim - 1,
                                        self.nx if self.x_fft else self.px),
                   dim)
        if self.x_fft:
            x = _pad_to(torch.fft.rfft(x, dim=-1), dim - 1, self.px)
        x = self._xcut_to_ycut(self._xcut_solve(self._ycut_to_xcut(x)))
        if self.x_fft:
            x = torch.fft.irfft(x[..., :self.nx // 2 + 1], n=self.nx,
                                dim=-1).to(self.dtype)
        return self._from_ycut(_dense(self.bwd_xz, x, dim))


def _full_spectrum(half: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """An eigenvalue array over the rfft's n // 2 + 1 frequencies of
    ``axis`` extended to all n (the symbol is even: entry k equals entry
    n - k)."""
    extra = n - half.shape[axis]
    return torch.cat([half, half.narrow(axis, 1, extra).flip(axis)],
                     dim=axis)


class _ContractionCore:
    """The separable solve on the rank's block of a field decomposed over
    a process group, with no repartition: the counterpart of GSPMD's
    tensordot over sharded axes (the JAX package on a 3-axis mesh, or
    with ``fdm.repartition: false``).

    Per direction, in the single device's order (x first): a dense
    transform along an axis the mesh does not cut is the block's own
    product; along a cut axis the rank multiplies its block by its
    columns of the factor (the whole axis comes out) and
    ``reduce_scatter`` sums the partial results over the ranks of that
    axis, leaving each rank its rows.  The FFTs follow (each axis's 1D
    complex FFT, on the pencils of whole lines where the axis is cut:
    ``LevelBlocks.to_pencil``), the divide by the eigenvalue sum over the
    full spectrum of the rank's block, the inverse FFTs, the real part,
    and the dense back-transforms.  The full spectrum keeps every block
    its extent (the single device's rfft halves the last FFT axis); the
    result equals it up to the order of the sums."""

    def __init__(self, part, field, fwd: list, bwd: list,
                 inv_lam: torch.Tensor, fft_axes: tuple, fft_sizes: tuple,
                 dtype: torch.dtype):
        self.dim = dim = part.dim
        self.dtype = dtype
        self.blocks = lb = LevelBlocks.of_field(part, field)
        ranges = [lb.range(d) for d in range(dim)]

        def cut(mats):
            """Direction d's factor, its columns of the rank's range
            where d is cut (a back transform's columns index the
            spectrum, cut as the field is)."""
            return [m if m is None or not lb.cut(d)
                    else m[:, ranges[d][0]:ranges[d][1]].contiguous()
                    for d, m in enumerate(mats)]

        self.fwd, self.bwd = cut(fwd), cut(bwd)
        #: the FFT directions, x first
        self.fft_dirs = sorted(dim - 1 - ax for ax in fft_axes)
        lam = inv_lam
        if fft_axes:
            rax = fft_axes[-1]
            lam = _full_spectrum(lam, rax, fft_sizes[-1])
        self.inv_lam = lam[lb.block()].contiguous()

    def _dense(self, mats: list, x: torch.Tensor, d: int) -> torch.Tensor:
        m = mats[d]
        one = [m if e == d else None for e in range(self.dim)]
        if not self.blocks.cut(d):
            return _apply_per_axis(one, x, self.dim)
        # the block's columns: the partial result over the whole axis
        return self.blocks.reduce_scatter(_apply_per_axis(one, x, self.dim),
                                          d)

    def _fft(self, x: torch.Tensor, d: int, inverse: bool) -> torch.Tensor:
        axis = self.dim - 1 - d
        fft = torch.fft.ifft if inverse else torch.fft.fft
        if not self.blocks.cut(d):
            return fft(x, dim=axis)
        lb = self.blocks
        parts = [x.real, x.imag] if x.is_complex() else [x]
        pen = lb.to_pencil(d, *parts)
        pen = pen[0] if len(pen) == 1 else torch.complex(*pen)
        pen = fft(pen, dim=axis)
        return torch.complex(*lb.from_pencil(d, pen.real.contiguous(),
                                             pen.imag.contiguous()))

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        x = b
        for d in range(self.dim):
            if self.fwd[d] is not None:
                x = self._dense(self.fwd, x, d)
        if self.fft_dirs:
            for d in self.fft_dirs:
                x = self._fft(x, d, inverse=False)
            x = x * self.inv_lam
            for d in self.fft_dirs:
                x = self._fft(x, d, inverse=True)
            x = x.real.to(self.dtype).contiguous()
        else:
            x = x * self.inv_lam
        for d in range(self.dim):
            if self.bwd[d] is not None:
                x = self._dense(self.bwd, x, d)
        return x


def _sharded_core(solver, part, field, fwd, bwd, repartition: bool = True):
    """The decomposed solve's core: the four all-to-alls on a 2-axis mesh
    with ``repartition``, else the contraction (JAX ``fdm.py:342, 494``:
    its repartitioning core exists on 2-axis meshes only)."""
    core = (_ShardedTransformCore if repartition
            and len(part.pmesh.shape) == 2 else _ContractionCore)
    return core(part, field, fwd, bwd, solver.inv_lam, solver._fft_axes,
                solver._fft_sizes, solver.dtype)


class FastDiagPoisson:
    """Direct separable solver of the (positive semidefinite) negated
    Poisson operator -D B1 G; the all-Neumann constant mode is zeroed."""

    def __init__(self, dxp: list, periodic: list, *, dtype: torch.dtype,
                 device, scale: float = 1.0, null_rtol: float = 1e-12,
                 use_fft: bool = True):
        """``dxp``: pressure cell widths per direction (x, y[, z]);
        ``scale``: the dt factor of B1; ``use_fft``: periodic uniformly
        spaced directions transform by rfft/irfft with the analytic
        symbol, the others by their dense eigenvectors (JAX's default)."""
        self.dim = len(dxp)
        self.dtype = dtype
        qs, qts, lams = [], [], []
        fft_axes, fft_scale = [], 1.0
        for d in range(self.dim):
            w = np.asarray(dxp[d], np.float64)
            h = _uniform_width(w) if (use_fft and periodic[d]) else None
            if h is not None:
                qs.append(None)
                qts.append(None)
                lams.append(_fft_symbol(len(w), h, scale))
                fft_axes.append(self.dim - 1 - d)
                # Q_d = F/sqrt(h): the unnormalized fft/ifft pair absorbs
                # F F^H = I but not the two 1/sqrt(h) weights
                fft_scale /= h
                continue
            T = line_operator(w, periodic[d], scale)
            # T q = lam W q via S = W^-1/2 T W^-1/2, Q = W^-1/2 V
            s = 1.0 / np.sqrt(w)
            lam, V = np.linalg.eigh(T * s[:, None] * s[None, :])
            Q = s[:, None] * V
            qs.append(torch.as_tensor(Q, dtype=dtype, device=device))
            qts.append(torch.as_tensor(Q.T.copy(), dtype=dtype, device=device))
            lams.append(np.maximum(lam, 0.0))
        self._fft_axes = tuple(sorted(fft_axes))
        self._fft_sizes = tuple(len(dxp[self.dim - 1 - ax])
                                for ax in self._fft_axes)
        lam_sum = _lam_sum(lams, self.dim, self._fft_axes)
        cutoff = null_rtol * lam_sum.max()
        self.inv_lam = torch.as_tensor(
            np.where(lam_sum > cutoff,
                     fft_scale / np.where(lam_sum > 0, lam_sum, 1.0), 0.0),
            dtype=dtype, device=device)
        self._Q = qs
        self._Qt = qts
        self._part = None
        self._core = None

    def set_mesh(self, part, repartition: bool = True) -> None:
        """Solve on the rank's pressure block of a decomposed run
        (``_sharded_core``; JAX ``fdm.py:337-347``)."""
        self._part = part
        self._core = _sharded_core(self, part, Field.P, self._Qt, self._Q,
                                   repartition)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """x = A^+ b.  The plain-sum (nullspace) component of b is projected
        out first; Q Lam^+ Q^T alone is only a reflexive inverse on
        stretched grids."""
        b = b.to(self.dtype)
        if self._core is not None:
            return self._core.solve(b - self._part.mean(b))
        b = b - torch.mean(b)
        return _fft_solve(b, self._Qt, self._Q, self.inv_lam, self.dim,
                          self._fft_axes, self._fft_sizes, self.dtype)


class FastDiagHelmholtz:
    """Direct solver of one velocity component's A = I/dt - c_imp*nu*L.

    Each BC-folded 1D operator T_d is symmetric under the W_d = diag(dl)
    weighting, so T_d = Q_d Lam_d Q_d^-1 with Q_d = W^-1/2 V_d and
    Q_d^-1 = V_d^T W^1/2 (forward and backward transforms differ)."""

    def __init__(self, lines1d: list, dt: float, cnu: float, *,
                 dtype: torch.dtype, device, use_fft: bool = True):
        """``lines1d``: per direction a dict with ``dl``, ``dneg``, ``dpos``
        (n,), ``a0`` ((lo, hi) or None when periodic) and ``periodic``;
        ``cnu`` = c_implicit * nu; ``use_fft``: periodic uniform directions
        (dl = dneg = dpos = h) have Q = F and Q^-1 = F^H, so rfft/irfft
        with the symbol -(2 - 2 cos(2 pi k / n))/h^2 replace their dense
        transforms (JAX ``fdm.py:402-489``)."""
        self.dim = len(lines1d)
        self.dtype = dtype
        qs, qinvs, lams = [], [], []
        fft_axes = []
        for d, ln in enumerate(lines1d):
            dl = np.asarray(ln["dl"], np.float64)
            dneg = np.asarray(ln["dneg"], np.float64)
            dpos = np.asarray(ln["dpos"], np.float64)
            n = len(dl)
            if use_fft and ln["periodic"]:
                h = _uniform_width(dl)
                if (h is not None
                        and np.allclose(dneg, h, rtol=1e-9, atol=0.0)
                        and np.allclose(dpos, h, rtol=1e-9, atol=0.0)):
                    qs.append(None)
                    qinvs.append(None)
                    lams.append(-_fft_symbol(n, h, 1.0))
                    fft_axes.append(self.dim - 1 - d)
                    continue
            cn = 1.0 / (dneg * dl)
            cp = 1.0 / (dpos * dl)
            T = np.zeros((n, n))
            idx = np.arange(n)
            T[idx, idx] = -(cn + cp)
            T[idx[1:], idx[:-1]] = cn[1:]
            T[idx[:-1], idx[1:]] = cp[:-1]
            if ln["periodic"]:
                T[0, -1] += cn[0]
                T[-1, 0] += cp[-1]
            else:
                a0_lo, a0_hi = ln["a0"]
                T[0, 0] += a0_lo * cn[0]      # ghost = a0 * target fold
                T[-1, -1] += a0_hi * cp[-1]
            s = np.sqrt(dl)
            S = T * (s[:, None] / s[None, :])
            asym = np.abs(S - S.T).max()
            if asym > 1e-10 * max(1.0, np.abs(S).max()):
                raise ValueError(
                    f"velocity 1D operator not W-symmetric (dev {asym:g})")
            lam, V = np.linalg.eigh(0.5 * (S + S.T))
            qs.append(torch.as_tensor(V / s[:, None], dtype=dtype,
                                      device=device))
            qinvs.append(torch.as_tensor((V * s[:, None]).T.copy(),
                                         dtype=dtype, device=device))
            lams.append(lam)
        self._fft_axes = tuple(sorted(fft_axes))
        self._fft_sizes = tuple(len(lines1d[self.dim - 1 - ax]["dl"])
                                for ax in self._fft_axes)
        # lam <= 0, so denom >= 1/dt > 0
        denom = 1.0 / dt - cnu * _lam_sum(lams, self.dim, self._fft_axes)
        self.inv_lam = torch.as_tensor(1.0 / denom, dtype=dtype,
                                       device=device)
        self._Q = qs
        self._Qinv = qinvs
        self._core = None

    def set_mesh(self, part, field, repartition: bool = True) -> None:
        """Solve on the rank's block of velocity ``field`` of a decomposed
        run (``_sharded_core``; JAX ``fdm.py:490-500``)."""
        self._core = _sharded_core(self, part, field, self._Qinv, self._Q,
                                   repartition)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        if self._core is not None:
            return self._core.solve(b.to(self.dtype))
        return _fft_solve(b.to(self.dtype), self._Qinv, self._Q,
                          self.inv_lam, self.dim, self._fft_axes,
                          self._fft_sizes, self.dtype)


def helmholtz_lines(mesh, bcset, c: int) -> list:
    """Per-direction 1D data of velocity component ``c``'s folded
    Laplacian (the coefficients make_laplacian bakes into its closures)."""
    out = []
    for d in range(mesh.dim):
        line = mesh.lines[Field(c)][d]
        if mesh.periodic[d]:
            a0 = None
        else:
            a0 = (bcset.specs[(c, 2 * d + 0)].a0,
                  bcset.specs[(c, 2 * d + 1)].a0)
        out.append({"dl": line.interior_dl, "dneg": line.dneg(),
                    "dpos": line.dpos(), "a0": a0,
                    "periodic": bool(mesh.periodic[d])})
    return out


def set_first(flat: torch.Tensor, value) -> torch.Tensor:
    """A copy of the 1D ``flat`` with entry 0 set to ``value`` (a number or
    a 0-d tensor, filled on the device: assigning a number would copy it
    from the host, which a CUDA graph's capture refuses)."""
    out = flat.clone()
    out[0].fill_(value)
    return out


def _leaf(tree, key):
    return tree if key is None else tree[key]


def _with_leaf(tree, key, value):
    return value if key is None else dict(tree, **{key: value})


def holds_first(part) -> bool:
    """Whether this rank holds the pressure's entry 0 (always, undivided):
    the block at the grid's origin."""
    return part is None or not any(part.origin())


def pinned_operator(A, key: str | None = None, part=None):
    """The pinned-pressure operator of the reference's GPU (AmgX) backend:
    A with row and column 0 of the pressure block replaced by the identity
    (MatZeroRowsColumns, navierstokes.cpp:414-420).  ``key`` names the
    pressure leaf when A acts on a dict (the coupled {p, f} system);
    ``part``: a decomposed run's ``Partition`` (entry 0 is on the block at
    the origin)."""
    first = holds_first(part)

    def apply(x):
        p = _leaf(x, key)
        flat = p.reshape(-1)
        if first:
            x = _with_leaf(x, key, set_first(flat, 0.0).reshape(p.shape))
        y = A(x)
        if not first:
            return y
        yp = _leaf(y, key)
        return _with_leaf(y, key, set_first(yp.reshape(-1), flat[0])
                          .reshape(yp.shape))

    return apply


class PinnedSolve:
    """The exact inverse of ``pinned_operator(A)`` from a projected solve
    ``inner.solve`` (a pseudo-inverse of A on its mean-free range).

    The pinned solution x has x[0] = r[0] =: s, and x - s e0 solves A on
    the rows != 0 with the right side r + beta e0, beta = s - sum(r) (the
    compatibility shift that makes it sum-free); the gauge is fixed by
    shifting the projected solution so its entry 0 is 0, then setting it
    to s (JAX ``navierstokes.py:428-436``, ``ibpm.py:198-221``).  On a
    decomposed run (``part``) the sum is the group's and the solution's
    entry 0 goes from the rank that holds it to all (one all-reduce
    each)."""

    def __init__(self, inner, key: str | None = None, part=None):
        self.inner = inner
        self.key = key
        self.part = part
        self.first = holds_first(part)

    def solve(self, r):
        rp = _leaf(r, self.key)
        flat = rp.reshape(-1)
        s = flat[0]
        total = torch.sum(flat)
        if self.part is not None:
            total = self.part.allreduce_sum(total)
        if self.first:
            r = _with_leaf(r, self.key, set_first(flat, s - total)
                           .reshape(rp.shape))  # beta: -sum over i != 0
        out = self.inner.solve(r)
        op = _leaf(out, self.key)
        of = op.reshape(-1)
        if self.part is None:
            return _with_leaf(out, self.key,
                              set_first(of - of[0], s).reshape(op.shape))
        o0 = self.part.allreduce_sum(of[0] if self.first
                                     else torch.zeros_like(of[0]))
        of = of - o0
        if self.first:
            of = set_first(of, s)
        return _with_leaf(out, self.key, of.reshape(op.shape))


def make_fdm_solver(fdm, A, opts: dict, reduce=None):
    """Direct solve + iterative refinement with KSP stopping semantics.

    ``fdm.solve(b)`` is a (near-)exact inverse on a tensor or dict of
    tensors, ``A`` the matching operator.  Returns ``solve(b, x0) ->
    SolveResult``: one warm-started direct pass, then passes while the
    recurrence residual r_{k+1} = r_k - A dx_k is above
    max(atol, rtol*||b||), still shrinks by at least 10% per pass, and
    fewer than max_it passes ran.  ``iters`` counts refinement passes.
    Arguments after ``x0`` go to ``A`` (a moving body's windows);
    ``reduce`` sums a decomposed run's norms over the process group."""
    atol = float(opts.get("atol", 1e-6))
    rtol = float(opts.get("rtol", 0.0))
    maxiter = int(opts.get("max_it", 10000))

    def solve(b, x0, *args) -> SolveResult:
        r = tmap(lambda bi, ax: bi - ax, b, A(x0, *args))
        dx = fdm.solve(r)
        x = tmap(lambda xi, di: xi + di, x0, dx)
        r = tmap(lambda ri, adi: ri - adi, r, A(dx, *args))
        # the predicate compares in the working dtype on the device, as
        # the JAX while_loop does
        tol = torch.clamp(rtol * _norm(b, reduce), min=atol)
        rn = _norm(r, reduce)
        prev = torch.full_like(rn, float("inf"))
        it = counter(rn)

        def more():
            return (rn > tol) & (rn < prev * 0.9) & (it < maxiter)

        pred = more()

        def body():
            dx = fdm.solve(r)
            tadd_(x, dx)
            tsub_(r, A(dx, *args))
            prev.copy_(rn)
            rn.copy_(_norm(r, reduce))
            it.add_(1)
            pred.copy_(more())

        loops.loop("refine", body, pred, maxiter)
        return SolveResult(x=x, iters=it, residual=rn, converged=rn <= tol)

    return solve
