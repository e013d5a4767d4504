"""Solve results, norms and the divergence error shared by the solvers.

Counterpart of the part of ``petibm_tpu/linalg/krylov.py`` this slice
uses (``SolveResult``, ``_norm``, ``SolverDivergedError``).  ``cg``,
``bicgstab`` and ``make_solver`` come with a later slice (ROADMAP item 5).
Operands are tensors or dicts of tensors (velocity fields).
"""

from __future__ import annotations

import dataclasses

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


@dataclasses.dataclass
class SolveResult:
    """A solve's solution and its stats, the stats as host values (the
    refinement loops read the residual on the host anyway)."""

    x: object
    iters: int
    residual: float
    converged: bool
