"""Matrix-free preconditioned CG and BiCGStab over tensors or dicts of
tensors.

Counterpart of ``petibm_tpu/linalg/krylov.py`` (reference: PETSc KSP,
src/linsolver/linsolverksp.cpp:48-107).  The stopping rule is KSP's
``||r|| <= max(atol, rtol*||b||)``.  The JAX package runs each method in a
``lax.while_loop``; here the loop runs on the host and reads the carried
squared residual once per iteration, comparing it in the working dtype, so
iteration counts, residuals and ok flags follow the same rules.  Scalars
(alpha, beta, omega, ...) stay 0-dim tensors on the device.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch


class SolverDivergedError(RuntimeError):
    """A linear solver failed to reach its tolerance (reference:
    linsolverksp.cpp:96-104 aborts with solver name, iterations and
    residual); raised from the iterations-log flush."""


def tmap(fn, *trees):
    """Apply ``fn`` leafwise over tensors or dicts of tensors."""
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree) -> list:
    # sorted keys: the JAX pytree order, so sums accumulate alike
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return [tree]


def _dot(x, y) -> torch.Tensor:
    return sum(torch.sum(a * b) for a, b in zip(_leaves(x), _leaves(y)))


def _norm(x) -> torch.Tensor:
    return torch.sqrt(_dot(x, x))


def host_scalars(*values: torch.Tensor) -> list:
    """0-dim tensors of one dtype -> numpy scalars of that dtype, in one
    host read (the JAX loops compare in the working dtype)."""
    np_dtype = {torch.float32: np.float32,
                torch.float64: np.float64}[values[0].dtype]
    return [np_dtype(v) for v in torch.stack(values).tolist()]


@dataclasses.dataclass
class SolveResult:
    """A solve's solution and its stats, the stats as host values (the
    loops read the residual on the host anyway)."""

    x: object
    iters: int
    residual: float
    converged: bool


def _identity(x):
    return x


def cg(A, b, x0, M=None, atol=1e-6, rtol=0.0, maxiter=10000) -> SolveResult:
    """Preconditioned conjugate gradient (KSPCG semantics); ||r||^2 is
    formed in the body beside r.z, as in the JAX package."""
    M = M or _identity
    x = x0
    r = tmap(lambda bi, ax: bi - ax, b, A(x0))
    z = M(r)
    p = z
    rz = _dot(r, z)
    rr = _dot(r, r)
    tol = torch.clamp(rtol * _norm(b), min=atol)
    tol2 = tol * tol
    rr_h, tol2_h = host_scalars(rr, tol2)
    it = 0
    while rr_h > tol2_h and it < maxiter:
        ap = A(p)
        alpha = rz / _dot(p, ap)
        x = tmap(lambda xi, pi: xi + alpha * pi, x, p)
        r = tmap(lambda ri, api: ri - alpha * api, r, ap)
        z = M(r)
        rz_new = _dot(r, z)
        rr = _dot(r, r)
        beta = rz_new / rz
        p = tmap(lambda zi, pi: zi + beta * pi, z, p)
        rz = rz_new
        it += 1
        rr_h = host_scalars(rr)[0]
    res, tol_h = host_scalars(torch.sqrt(rr), tol)
    return SolveResult(x=x, iters=it, residual=float(res),
                       converged=bool(res <= tol_h))


def bicgstab(A, b, x0, M=None, atol=1e-6, rtol=0.0,
             maxiter=10000) -> SolveResult:
    """Preconditioned BiCGStab (KSPBCGS semantics).  The convergence check
    uses the recurrence ||r||^2 = s.s - 2 omega t.s + omega^2 t.t, as in
    the JAX package; the final residual is one exact norm."""
    M = M or _identity
    x = x0
    r = tmap(lambda bi, ax: bi - ax, b, A(x0))
    r0 = r
    bnorm = _norm(b)
    tol = torch.clamp(rtol * bnorm, min=atol)
    tol2 = tol * tol
    one = torch.ones((), dtype=bnorm.dtype, device=bnorm.device)
    zero = torch.zeros((), dtype=bnorm.dtype, device=bnorm.device)
    p = tmap(torch.zeros_like, x0)
    v = tmap(torch.zeros_like, x0)
    rho = alpha = omega = one
    rr = _dot(r, r)
    rr_h, tol2_h = host_scalars(rr, tol2)
    it = 0
    while rr_h > tol2_h and it < maxiter:
        rho_new = _dot(r0, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = tmap(lambda ri, pi, vi: ri + beta * (pi - omega * vi), r, p, v)
        phat = M(p)
        v = A(phat)
        alpha = rho_new / _dot(r0, v)
        s = tmap(lambda ri, vi: ri - alpha * vi, r, v)
        shat = M(s)
        t = A(shat)
        tt = _dot(t, t)
        ts = _dot(t, s)
        ss = _dot(s, s)
        omega = torch.where(tt > 0, ts / torch.where(tt > 0, tt, one), one)
        x = tmap(lambda xi, ph, sh: xi + alpha * ph + omega * sh,
                 x, phat, shat)
        r = tmap(lambda si, ti: si - omega * ti, s, t)
        rr = torch.maximum(ss - 2.0 * omega * ts + omega * omega * tt, zero)
        rho = rho_new
        it += 1
        rr_h = host_scalars(rr)[0]
    res, tol_h = host_scalars(_norm(r), tol)
    # the recurrence rr can disagree with the exact norm by cancellation
    # right at the tolerance boundary; either passing counts as converged
    ok = bool(res <= tol_h) or bool(rr_h <= tol2_h)
    return SolveResult(x=x, iters=it, residual=float(res), converged=ok)


_METHODS = {"cg": cg, "bicgstab": bicgstab}


def make_solver(A, opts: dict, M=None):
    """Bind an operator and solver options into ``solve(b, x0) ->
    SolveResult`` (reference: linsolver::createLinSolver,
    src/linsolver/linsolver.cpp:57-91)."""
    method = _METHODS[opts.get("type", "cg")]
    return partial(_solve, method, A, M, float(opts.get("atol", 1e-6)),
                   float(opts.get("rtol", 0.0)),
                   int(opts.get("max_it", 10000)))


def _solve(method, A, M, atol, rtol, maxiter, b, x0):
    return method(A, b, x0, M=M, atol=atol, rtol=rtol, maxiter=maxiter)
