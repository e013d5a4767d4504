"""Decoupled immersed-boundary projection method (Li et al. 2016).

Counterpart of ``petibm_tpu/solvers/decoupledibpm.py`` for stationary
bodies (decoupledibpm.py:40-163, 218-269; reference
applications/decoupledibpm).  The projection step gains a Lagrangian force
solve:

  1. rhs1 = NS rhs + H f
  2. momentum solve -> u*
  3. rhsf = -E u*
  4. solve (E B_N H) df = rhsf
  5. u** = u* + B_N H df   (no-slip correction)
  6. Poisson solve, projection, pressure update as in NS
  7. f += df

For BN order 1, E B1 H = dt * E H is block-diagonal over velocity
components with dense (N, N) blocks built from the window factors.  For a
stationary body the blocks are constant: they are inverted once at setup
(host numpy float64) and each step applies the inverse with refinement
against the blocks (``make_fdm_solver`` semantics).  Moving bodies are
ROADMAP item 11; the matrix-free Krylov force solve (``dense: false``)
ROADMAP item 18.
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


class DecoupledIBPMSolver(ForcesLogMixin, NavierStokesSolver):

    def _extra_init(self, config: dict) -> None:
        if any("kinematics" in (node or {})
               for node in config.get("bodies", []) or []):
            raise _not_ported("moving bodies (kinematics)", "ROADMAP item 11")
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
        # stationary bodies: windows computed once
        self._static_windows = self.delta.windows(
            torch.as_tensor(self.bodies.all_coords(), dtype=self.dtype,
                            device=self.device))
        self._make_force_solver(solver_config(config, "forces"))

    def _make_force_solver(self, fopts: dict) -> None:
        """The setup-time inverted dense EBNH force solve
        (decoupledibpm.py:83-163); BN order 1 only, as in the JAX package."""
        if self.bn_order != 1:
            raise _not_ported("BN > 1 with the decoupled IBPM (its force "
                              "solve is the matrix-free Krylov one)",
                              "ROADMAP item 18")
        if not bool(fopts.get("dense", True)):
            raise _not_ported("forcesSolver.dense: false (matrix-free Krylov "
                              "force solve)", "ROADMAP item 18")
        dim = self.mesh.dim
        mats = dense_ebnh_blocks(self._static_windows, dim, self.dt)
        inv = [torch.as_tensor(np.linalg.inv(m.cpu().numpy().astype(np.float64)),
                               dtype=self.dtype, device=self.device)
               for m in mats]

        class _InvBlocks:
            @staticmethod
            def solve(r):
                return torch.stack([inv[c] @ r[:, c] for c in range(dim)],
                                   dim=1)

        def A_dense(df):
            return torch.stack([mats[c] @ df[:, c] for c in range(dim)], dim=1)

        refine = make_fdm_solver(_InvBlocks, A_dense, fopts)

        def solve_forces(rhsf, x0=None):
            return refine(rhsf, torch.zeros_like(rhsf) if x0 is None else x0)

        self._solve_forces = solve_forces

    # ------------------------------------------------------------------
    def _build_step(self):
        win = self._static_windows

        def step(state):
            # momentum RHS + spread forces (decoupledibpm.cpp:245)
            rhs1, state = self._rhs_velocity(state)
            hf = self.delta.spread(state["f"], win)
            rhs1 = tmap(lambda r, x: r + x, rhs1, hf)
            vsol = self._solve_velocity(rhs1, state)
            ustar = vsol.x

            # force system (decoupledibpm.cpp:253-285)
            rhsf = -self.delta.interpolate(ustar, win)
            x0 = state["df"] if self.warm_start_poisson else None
            fsol = self._solve_forces(rhsf, x0)
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
