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

Not ported yet: the sharded transform core (ROADMAP item 19), and the
``precision`` knobs of the transforms (full precision of the working
dtype here).
"""

from __future__ import annotations

import numpy as np
import torch

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

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """x = A^+ b.  The plain-sum (nullspace) component of b is projected
        out first; Q Lam^+ Q^T alone is only a reflexive inverse on
        stretched grids."""
        b = b.to(self.dtype)
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

    def solve(self, b: torch.Tensor) -> torch.Tensor:
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


def pinned_operator(A, key: str | None = None):
    """The pinned-pressure operator of the reference's GPU (AmgX) backend:
    A with row and column 0 of the pressure block replaced by the identity
    (MatZeroRowsColumns, navierstokes.cpp:414-420).  ``key`` names the
    pressure leaf when A acts on a dict (the coupled {p, f} system)."""

    def apply(x):
        p = _leaf(x, key)
        flat = p.reshape(-1)
        y = A(_with_leaf(x, key, set_first(flat, 0.0).reshape(p.shape)))
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
    to s (JAX ``navierstokes.py:428-436``, ``ibpm.py:198-221``)."""

    def __init__(self, inner, key: str | None = None):
        self.inner = inner
        self.key = key

    def solve(self, r):
        rp = _leaf(r, self.key)
        flat = rp.reshape(-1)
        s = flat[0]
        beta = s - torch.sum(flat)  # -sum over i != 0
        out = self.inner.solve(_with_leaf(
            r, self.key, set_first(flat, beta).reshape(rp.shape)))
        op = _leaf(out, self.key)
        of = op.reshape(-1)
        return _with_leaf(out, self.key,
                          set_first(of - of[0], s).reshape(op.shape))


def make_fdm_solver(fdm, A, opts: dict):
    """Direct solve + iterative refinement with KSP stopping semantics.

    ``fdm.solve(b)`` is a (near-)exact inverse on a tensor or dict of
    tensors, ``A`` the matching operator.  Returns ``solve(b, x0) ->
    SolveResult``: one warm-started direct pass, then passes while the
    recurrence residual r_{k+1} = r_k - A dx_k is above
    max(atol, rtol*||b||), still shrinks by at least 10% per pass, and
    fewer than max_it passes ran.  ``iters`` counts refinement passes.
    Arguments after ``x0`` go to ``A`` (a moving body's windows)."""
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
        tol = torch.clamp(rtol * _norm(b), min=atol)
        rn = _norm(r)
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
            rn.copy_(_norm(r))
            it.add_(1)
            pred.copy_(more())

        loops.loop("refine", body, pred, maxiter)
        return SolveResult(x=x, iters=it, residual=rn, converged=rn <= tol)

    return solve
