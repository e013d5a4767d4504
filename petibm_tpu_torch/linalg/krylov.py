"""Matrix-free preconditioned CG and BiCGStab over tensors or dicts of
tensors.

Counterpart of ``petibm_tpu/linalg/krylov.py`` (reference: PETSc KSP,
src/linsolver/linsolverksp.cpp:48-107).  The stopping rule is KSP's
``||r|| <= max(atol, rtol*||b||)``.  The JAX package runs each method in a
``lax.while_loop``; here each method is one loop body that updates its
carries in place and recomputes its predicate on the device, compared in
the working dtype, run by the current driver of ``loops.py`` (the host
driver reads the predicate once per iteration; the guarded driver of a
chunk reads nothing), so iteration counts, residuals and ok flags follow
the same rules.  Scalars (alpha, beta, omega, ...) and the stats stay
0-dim tensors on the device.  On decomposed fields every inner product
is summed over the process group (``reduce``), so each rank reads the
same predicate and runs the same iterations.  A solve given a ``region``
stamps each iteration of its body as that region of a traced step
(``utils/stamps.py``).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from ..utils import stamps
from . import loops


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


def _dot(x, y, reduce=None) -> torch.Tensor:
    """The inner product; ``reduce`` sums a decomposed run's per-rank
    partial over the process group (``parallel.dist.GroupSum``).  The
    leaves of a dict that ``reduce.replicated`` names are whole on every
    rank: the decomposed leaves' partials are summed over the group
    alone, and each replicated leaf's product enters once, in the sorted
    key order of the JAX pytree (the coupled {f, p}: f·f + sum(p·p))."""
    sums = [torch.sum(a * b) for a, b in zip(_leaves(x), _leaves(y))]
    if reduce is None:
        return sum(sums)
    replicated = getattr(reduce, "replicated", ())
    if not isinstance(x, dict) or not replicated.intersection(x):
        return reduce(sum(sums))
    keys = sorted(x)
    group = reduce(sum(s for k, s in zip(keys, sums) if k not in replicated))
    out, added = None, False
    for k, s in zip(keys, sums):
        if k not in replicated:
            if added:
                continue
            s, added = group, True
        out = s if out is None else out + s
    return out


def _norm(x, reduce=None) -> torch.Tensor:
    return torch.sqrt(_dot(x, x, reduce))



@dataclasses.dataclass
class SolveResult:
    """A solve's solution and its stats, the stats 0-d tensors on the
    solution's device (``iters`` int64, ``residual`` in the working dtype,
    ``converged`` bool); host readers convert them at the flush, as the
    JAX package reads its stats.  ``fallback``: where a moving body's
    force solve took its dense branch (a 0-d bool), else None."""

    x: object
    iters: torch.Tensor
    residual: torch.Tensor
    converged: torch.Tensor
    fallback: torch.Tensor | None = None


def _identity(x):
    return x


def tclone(tree):
    """A copy of a tensor or dict of tensors: a carry the loop updates in
    place, leaving its source as it was."""
    return tmap(torch.clone, tree)


def tadd_(x, y, scale=None) -> None:
    """x += y (x += scale * y), leafwise in place; rounds as ``x + y``
    (``x + scale * y``)."""
    for a, b in zip(_leaves(x), _leaves(y)):
        a.add_(b if scale is None else scale * b)


def tsub_(x, y, scale=None) -> None:
    """x -= y (x -= scale * y), leafwise in place."""
    for a, b in zip(_leaves(x), _leaves(y)):
        a.sub_(b if scale is None else scale * b)


def tcopy_(x, y) -> None:
    for a, b in zip(_leaves(x), _leaves(y)):
        a.copy_(b)


def counter(like: torch.Tensor) -> torch.Tensor:
    """A loop's iteration counter: a 0-d int64 zero on ``like``'s device."""
    return torch.zeros((), dtype=torch.int64, device=like.device)


def _in_region(region: str | None, body):
    """``body``, each run of it stamped as ``region`` (None: as it is)."""
    if region is None:
        return body

    def stamped():
        with stamps.region(region):
            body()

    return stamped


def cg(A, b, x0, M=None, atol=1e-6, rtol=0.0, maxiter=10000,
       reduce=None, region=None) -> SolveResult:
    """Preconditioned conjugate gradient (KSPCG semantics); ||r||^2 is
    formed in the body beside r.z, as in the JAX package.  The loop runs
    on the current driver (``loops.py``) while ``rr > tol^2`` and ``it <
    maxiter``, compared in the working dtype on the device."""
    M = M or _identity
    dot = partial(_dot, reduce=reduce)
    x = tclone(x0)
    r = tmap(lambda bi, ax: bi - ax, b, A(x0))
    p = tclone(M(r))
    rz = dot(r, p)
    rr = dot(r, r)
    tol = torch.clamp(rtol * _norm(b, reduce), min=atol)
    tol2 = tol * tol
    it = counter(rr)
    pred = (rr > tol2) & (it < maxiter)

    def body():
        ap = A(p)
        alpha = rz / dot(p, ap)
        tadd_(x, p, alpha)
        tsub_(r, ap, alpha)
        z = M(r)
        rz_new = dot(r, z)
        rr.copy_(dot(r, r))
        beta = rz_new / rz
        # z + beta p, bit for bit
        for pi, zi in zip(_leaves(p), _leaves(z)):
            pi.mul_(beta).add_(zi)
        rz.copy_(rz_new)
        it.add_(1)
        pred.copy_((rr > tol2) & (it < maxiter))

    loops.loop("cg", _in_region(region, body), pred, maxiter,
               (x, r, p, rz, rr, it))
    res = torch.sqrt(rr)
    return SolveResult(x=x, iters=it, residual=res, converged=res <= tol)


def bicgstab(A, b, x0, M=None, atol=1e-6, rtol=0.0,
             maxiter=10000, reduce=None, region=None) -> SolveResult:
    """Preconditioned BiCGStab (KSPBCGS semantics).  The convergence check
    uses the recurrence ||r||^2 = s.s - 2 omega t.s + omega^2 t.t, as in
    the JAX package; the final residual is one exact norm."""
    M = M or _identity
    dot = partial(_dot, reduce=reduce)
    x = tclone(x0)
    r = tmap(lambda bi, ax: bi - ax, b, A(x0))
    r0 = tclone(r)
    bnorm = _norm(b, reduce)
    tol = torch.clamp(rtol * bnorm, min=atol)
    tol2 = tol * tol
    one = torch.ones((), dtype=bnorm.dtype, device=bnorm.device)
    zero = torch.zeros((), dtype=bnorm.dtype, device=bnorm.device)
    p = tmap(torch.zeros_like, x0)
    v = tmap(torch.zeros_like, x0)
    rho, alpha, omega = one.clone(), one.clone(), one.clone()
    rr = dot(r, r)
    it = counter(rr)
    pred = (rr > tol2) & (it < maxiter)

    def body():
        rho_new = dot(r0, r)
        beta = (rho_new / rho) * (alpha / omega)
        tcopy_(p, tmap(lambda ri, pi, vi: ri + beta * (pi - omega * vi),
                       r, p, v))
        phat = M(p)
        tcopy_(v, A(phat))
        alpha.copy_(rho_new / dot(r0, v))
        s = tmap(lambda ri, vi: ri - alpha * vi, r, v)
        shat = M(s)
        t = A(shat)
        tt = dot(t, t)
        ts = dot(t, s)
        ss = dot(s, s)
        omega.copy_(torch.where(tt > 0, ts / torch.where(tt > 0, tt, one),
                                one))
        tadd_(x, phat, alpha)
        tadd_(x, shat, omega)
        tcopy_(r, tmap(lambda si, ti: si - omega * ti, s, t))
        rr.copy_(torch.maximum(ss - 2.0 * omega * ts + omega * omega * tt,
                               zero))
        rho.copy_(rho_new)
        it.add_(1)
        pred.copy_((rr > tol2) & (it < maxiter))

    loops.loop("bicgstab", _in_region(region, body), pred, maxiter,
               (x, r, p, v, rho, alpha, omega, rr, it))
    res = _norm(r, reduce)
    # the recurrence rr can disagree with the exact norm by cancellation
    # right at the tolerance boundary; either passing counts as converged
    ok = (res <= tol) | (rr <= tol2)
    return SolveResult(x=x, iters=it, residual=res, converged=ok)


_METHODS = {"cg": cg, "bicgstab": bicgstab}


def make_solver(A, opts: dict, M=None, reduce=None, region=None):
    """Bind an operator and solver options into ``solve(b, x0) ->
    SolveResult`` (reference: linsolver::createLinSolver,
    src/linsolver/linsolver.cpp:57-91); ``reduce`` as for ``_dot``;
    ``region`` the stamps' name of an iteration (``utils/stamps.py``)."""
    method = _METHODS[opts.get("type", "cg")]
    return partial(_solve, method, A, M, float(opts.get("atol", 1e-6)),
                   float(opts.get("rtol", 0.0)),
                   int(opts.get("max_it", 10000)), reduce, region)


def _solve(method, A, M, atol, rtol, maxiter, reduce, region, b, x0):
    kw = {} if reduce is None else {"reduce": reduce}
    if region is not None:
        kw["region"] = region
    return method(A, b, x0, M=M, atol=atol, rtol=rtol, maxiter=maxiter, **kw)
