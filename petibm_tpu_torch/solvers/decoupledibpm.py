"""Decoupled immersed-boundary projection method (Li et al. 2016).

Counterpart of ``petibm_tpu/solvers/decoupledibpm.py`` (:40-262, 345-362;
reference applications/decoupledibpm).  The projection step gains a
Lagrangian force solve:

  1. rhs1 = NS rhs + H f
  2. momentum solve -> u*
  3. rhsf = -E u*  (+ UB, the body velocity, for moving bodies)
  4. solve (E B_N H) df = rhsf
  5. u** = u* + B_N H df   (no-slip correction)
  6. Poisson solve, projection, pressure update as in NS
  7. f += df

For BN order 1, E B1 H = dt * E H is block-diagonal over velocity
components with dense (N, N) blocks built from the window factors.  For a
stationary body the blocks are constant: they are inverted once at setup
(host numpy float64) and each step applies the inverse with refinement
against the blocks (``make_fdm_solver`` semantics).  The hooks
``_pre_step``, ``_windows`` and ``_body_velocity`` are where a moving
body (``solvers/rigidkinematics.py``) enters the step.  The
matrix-free Krylov force solve (``dense: false``) is ROADMAP item 18.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import solver_config
from ..ibm.body import BodyPack
from ..ibm.interp import dense_ebnh_blocks, make_delta_op
from ..linalg.fdm import make_fdm_solver
from ..linalg.krylov import tmap
from ._forceslog import ForcesLogMixin
from .navierstokes import NavierStokesSolver, _not_ported


def blocks_apply(mats, x):
    """Each velocity component's (N, N) block applied to its column of x."""
    return torch.stack([mats[c] @ x[:, c] for c in range(len(mats))], dim=1)


class BlockInverse:
    """The inverse of the dense E B_N H blocks, taken once on the host in
    float64; ``solve`` is the direct pass of ``make_fdm_solver``."""

    def __init__(self, mats, dtype, device):
        self.inv = [torch.as_tensor(
            np.linalg.inv(m.cpu().numpy().astype(np.float64)), dtype=dtype,
            device=device) for m in mats]

    def solve(self, r):
        return blocks_apply(self.inv, r)


class DecoupledIBPMSolver(ForcesLogMixin, NavierStokesSolver):
    def _extra_init(self, config: dict) -> None:
        self._refuse_kinematics(config)
        self.bodies = BodyPack(config, self.mesh)
        if self.bodies.n_bodies == 0:
            raise ValueError("decoupled IBPM requires at least one body")
        params = config.get("parameters", {})
        self.delta = make_delta_op(
            self.mesh, params.get("delta", "ROMA_ET_AL_1999"),
            dtype=self.dtype, device=self.device, n_pts=self.bodies.n_pts,
            engine=params.get("deltaEngine", "auto"))
        self.state["f"] = torch.zeros((self.bodies.n_pts, self.mesh.dim),
                                      dtype=self.dtype, device=self.device)
        self.state["df"] = torch.zeros_like(self.state["f"])
        # the windows at the body's first coordinates: a stationary body's
        # for good, a moving body's for the setup-time inverse
        self._static_windows = self.delta.windows(
            torch.as_tensor(self.bodies.all_coords(), dtype=self.dtype,
                            device=self.device))
        self._make_force_solver(solver_config(config, "forces"))

    def _refuse_kinematics(self, config: dict) -> None:
        if any("kinematics" in (node or {})
               for node in config.get("bodies", []) or []):
            raise NotImplementedError(
                "bodies with kinematics move: run them with "
                "RigidKinematicsSolver (solvers/rigidkinematics.py, "
                "cli/rigidkinematics.py); the decoupled solver's bodies are "
                "stationary")

    def _dense_force_blocks(self, fopts: dict) -> tuple:
        """The dense E B_N H blocks of BN order 1 at the body's first
        coordinates and their inverse (JAX decoupledibpm.py:83-95)."""
        if self.bn_order != 1:
            raise _not_ported("BN > 1 with the decoupled IBPM (its force "
                              "solve is the matrix-free Krylov one)",
                              "ROADMAP item 18")
        if not bool(fopts.get("dense", True)):
            raise _not_ported("forcesSolver.dense: false (matrix-free Krylov "
                              "force solve)", "ROADMAP item 18")
        mats = dense_ebnh_blocks(self._static_windows, self.mesh.dim, self.dt)
        return mats, BlockInverse(mats, self.dtype, self.device)

    def _make_force_solver(self, fopts: dict) -> None:
        """The stationary body's force solve, as in the JAX package
        (decoupledibpm.py:133-172): the blocks inverted once at setup, then
        refinement against the blocks."""
        mats, inverse = self._dense_force_blocks(fopts)
        refine = make_fdm_solver(inverse, lambda df: blocks_apply(mats, df),
                                 fopts)

        def solve_forces(rhsf, win, x0=None):
            return refine(rhsf, torch.zeros_like(rhsf) if x0 is None else x0)

        self._solve_forces = solve_forces

    # ------------------------------------------------------------------
    def _pre_step(self, state):
        """Hook run at the top of the step (rigid-kinematics body motion)."""
        return state

    def _windows(self, state):
        """Current delta windows (static for stationary bodies)."""
        return self._static_windows

    def _body_velocity(self, state):
        """Lagrangian boundary velocity UB (None for stationary bodies;
        rigidkinematics.cpp:143-159)."""
        return None

    def _build_step(self):
        def step(state):
            state = self._pre_step(state)
            win = self._windows(state)
            # momentum RHS + spread forces (decoupledibpm.cpp:245)
            rhs1, state = self._rhs_velocity(state)
            hf = self.delta.spread(state["f"], win)
            rhs1 = tmap(lambda r, x: r + x, rhs1, hf)
            vsol = self._solve_velocity(rhs1, state)
            ustar = vsol.x

            # force system (decoupledibpm.cpp:253-285)
            rhsf = -self.delta.interpolate(ustar, win)
            ub = self._body_velocity(state)
            if ub is not None:
                rhsf = rhsf + ub
            x0 = state["df"] if self.warm_start_poisson else None
            fsol = self._solve_forces(rhsf, win, x0)
            df = fsol.x

            # no-slip correction u** = u* + BN H df (decoupledibpm.cpp:288-299)
            ustar = tmap(lambda u, x: u + x, ustar,
                         self.bn(self.delta.spread(df, win)))

            qnew, pnew, dP, psol = self._poisson_project(ustar, state)
            bcstate = self.bc.update_ghost_values(state["bc"], qnew)
            fnew = state["f"] + df
            stats = {"v_iters": vsol.iters, "v_res": vsol.residual,
                     "v_ok": vsol.converged,
                     "p_iters": psol.iters, "p_res": psol.residual,
                     "p_ok": psol.converged,
                     "f_iters": fsol.iters, "f_res": fsol.residual,
                     "f_ok": fsol.converged,
                     "f": fnew}
            return dict(state, q=qnew, p=pnew, bc=bcstate, dP=dP, df=df,
                        f=fnew), stats

        return step

    # ------------------------------------------------------------------
    def _iter_log_stats(self, s: dict):
        return super()._iter_log_stats(s) + [(s["f_iters"], s["f_res"])]

    def _restart_extra(self) -> dict:
        # df rides along: the force solve warm-starts from it
        return dict(super()._restart_extra(), force=self.state["f"],
                    dF=self.state["df"])

    def _read_restart_extra(self, extra: dict) -> None:
        super()._read_restart_extra(extra)
        shape = (self.bodies.n_pts, self.mesh.dim)
        if "force" in extra:
            self.state["f"] = self._tensor(extra["force"].reshape(shape))
        if "dF" in extra:
            self.state["df"] = self._tensor(extra["dF"].reshape(shape))
