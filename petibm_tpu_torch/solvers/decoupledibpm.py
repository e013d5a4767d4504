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
against the blocks (``make_fdm_solver`` semantics).  BN > 1, the
windowed delta engine and ``forcesSolver.dense: false`` take the
matrix-free Krylov force solve instead (JAX :211-215): the force
solver's method (CG by default) on E B_N H applied as interpolate after
spread, with no preconditioner.  The hooks ``_pre_step``, ``_windows``
and ``_body_velocity`` are where a moving body
(``solvers/rigidkinematics.py``) enters the step.

On a decomposed run the forces and their solve stay replicated: every
rank holds the full factor rows and the dense blocks (built from them at
setup, no communication) and E sums the ranks' partials, so each rank
solves the same force system (the dense blocks, or the Krylov solve on
replicated vectors).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import solver_config
from ..ibm.body import BodyPack
from ..ibm.interp import dense_ebnh_blocks, make_delta_op
from ..linalg.fdm import make_fdm_solver
from ..linalg.krylov import make_solver, tmap
from ._forceslog import ForcesLogMixin
from .navierstokes import NavierStokesSolver


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
        if self.part is not None:
            self.delta.set_mesh(self.part)
        self.state["f"] = torch.zeros((self.bodies.n_pts, self.mesh.dim),
                                      dtype=self.dtype, device=self.device)
        self.state["df"] = torch.zeros_like(self.state["f"])
        # the windows at the body's first coordinates: a stationary body's
        # for good, a moving body's for the setup-time inverse; the dense
        # blocks take the full rows, the step the rank's columns
        self._full_windows = self.delta.windows(
            torch.as_tensor(self.bodies.all_coords(), dtype=self.dtype,
                            device=self.device))
        self._static_windows = self.delta.local_windows(self._full_windows)
        self._make_force_solver(solver_config(config, "forces"))

    def _refuse_kinematics(self, config: dict) -> None:
        if any("kinematics" in (node or {})
               for node in config.get("bodies", []) or []):
            raise NotImplementedError(
                "bodies with kinematics move: run them with "
                "RigidKinematicsSolver (solvers/rigidkinematics.py, "
                "cli/rigidkinematics.py); the decoupled solver's bodies are "
                "stationary")

    def _ebnh(self, df, win):
        """E B_N H df, matrix-free (interpolate after spread)."""
        return self.delta.interpolate(self.bn(self.delta.spread(df, win)),
                                      win)

    def _dense_forces(self, fopts: dict) -> bool:
        """The dense block solve: BN order 1 and factor windows, unless
        ``forcesSolver.dense: false`` (JAX decoupledibpm.py:83-85)."""
        blocks = self.bn_order == 1 and not self.delta.windowed
        return bool(fopts.get("dense", blocks)) and blocks

    def _dense_force_blocks(self) -> tuple:
        """The dense E B1 H blocks at the body's first coordinates and
        their inverse (JAX decoupledibpm.py:88-95, 150-155)."""
        mats = dense_ebnh_blocks(self._full_windows, self.mesh.dim, self.dt)
        with self.timers.stage("forces.invert"):
            return mats, BlockInverse(mats, self.dtype, self.device)

    def _make_force_solver(self, fopts: dict) -> None:
        """The force solve, as the JAX package chooses it: the dense one
        (``_make_dense_force_solver``) or the matrix-free Krylov one
        (decoupledibpm.py:211-215)."""
        self._fopts = fopts
        if self._dense_forces(fopts):
            self._make_dense_force_solver(fopts)
            return
        ebnh = self._ebnh

        def solve_forces(rhsf, win, x0=None, full=None):
            solver = make_solver(lambda df: ebnh(df, win), fopts)
            return solver(rhsf, torch.zeros_like(rhsf) if x0 is None else x0)

        self._solve_forces = solve_forces

    def _make_dense_force_solver(self, fopts: dict) -> None:
        """The stationary body's dense force solve (JAX
        decoupledibpm.py:133-172): the blocks inverted once at setup, then
        refinement against the blocks."""
        mats, inverse = self._dense_force_blocks()
        refine = make_fdm_solver(inverse, lambda df: blocks_apply(mats, df),
                                 fopts)

        def solve_forces(rhsf, win, x0=None, full=None):
            return refine(rhsf, torch.zeros_like(rhsf) if x0 is None else x0)

        self._solve_forces = solve_forces

    # ------------------------------------------------------------------
    def _pre_step(self, state):
        """Hook run at the top of the step (rigid-kinematics body motion)."""
        return state

    def _windows(self, state):
        """The step's delta windows, (the full factor rows, the rank's
        columns): static for stationary bodies."""
        return self._full_windows, self._static_windows

    def _body_velocity(self, state):
        """Lagrangian boundary velocity UB (None for stationary bodies;
        rigidkinematics.cpp:143-159)."""
        return None

    def _step_stats(self, ctx: dict) -> dict:
        # forces ride along in the stats: the forces log reads them
        fsol = ctx["fsol"]
        return dict(super()._step_stats(ctx), f_iters=fsol.iters,
                    f_res=fsol.residual, f_ok=fsol.converged,
                    f=ctx["state"]["f"])

    # ------------------------------------------------------------------
    def _profile_phases(self):
        """The step as the reference's IBM log stages (JAX
        ``decoupledibpm.py:274-330``; decoupledibpm.cpp:93-97,
        rigidkinematics.cpp:58): the NS stages with moveIB ahead, the
        spread forces in the velocity RHS (decoupledibpm.cpp:245), the
        force system (:253-285) and the no-slip correction u** = u* +
        B_N H df (:288-299) after the momentum solve; f += df in the
        update.  Both spreads add into the step's own rhs1 and u* (in
        place on the factor engine undecomposed, ``DeltaOp.spread``)."""
        ns = dict(super()._profile_phases())

        def moveIB(ctx):
            state = self._pre_step(ctx["state"])
            full, win = self._windows(state)
            return dict(ctx, state=state, win=win, win_full=full)

        def rhsVelocity(ctx):
            rhs1, state = self._rhs_velocity(ctx["state"])
            return dict(ctx, state=state, rhs1=self.delta.spread(
                state["f"], ctx["win"], into=rhs1))

        def rhsForces(ctx):
            rhsf = -self.delta.interpolate(ctx["ustar"], ctx["win"])
            ub = self._body_velocity(ctx["state"])
            if ub is not None:
                rhsf = rhsf + ub
            return dict(ctx, rhsf=rhsf)

        def solveForces(ctx):
            state = ctx["state"]
            x0 = state["df"] if self.warm_start_poisson else None
            fsol = self._solve_forces(ctx["rhsf"], ctx["win"], x0,
                                      ctx["win_full"])
            return dict(ctx, fsol=fsol, df=fsol.x)

        def applyNoSlip(ctx):
            if self.bn_order == 1:  # B_1 = dt I, folded into the spread
                ustar = self.delta.spread(ctx["df"], ctx["win"],
                                          into=ctx["ustar"], scale=self.dt)
            else:
                hdf = self.bn(self.delta.spread(ctx["df"], ctx["win"]))
                ustar = tmap(lambda u, x: u + x, ctx["ustar"], hdf)
            return dict(ctx, ustar=ustar)

        def update(ctx):
            ctx = ns["update"](ctx)
            state = ctx["state"]
            return dict(ctx, state=dict(state, df=ctx["df"],
                                        f=state["f"] + ctx["df"]))

        return [("moveIB", moveIB),
                ("rhsVelocity", rhsVelocity),
                ("solveVelocity", ns["solveVelocity"]),
                ("rhsForces", rhsForces),
                ("solveForces", solveForces),
                ("applyNoSlip", applyNoSlip),
                ("rhsPoisson", ns["rhsPoisson"]),
                ("solvePoisson", ns["solvePoisson"]),
                ("update", update)]

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
