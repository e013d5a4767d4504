"""Prescribed-kinematics moving rigid bodies on the decoupled IBPM.

Counterpart of ``petibm_tpu/solvers/rigidkinematics.py`` (reference:
applications/rigidkinematics/rigidkinematics.{h,cpp}).  The body
coordinates are a function of time evaluated at the top of each step:
the delta windows are recomputed from them on the device.  With the
dense force solve (BN order 1, factor windows, ``dense`` not false) the
step keeps the inverse taken at the body's first coordinates and refines
against the matrix-free E B_N H of the step's windows; where that
refinement exits above tolerance, the step solves the dense blocks of its
windows directly (``fallbacks`` counts those steps).  Otherwise the step
takes the decoupled solver's matrix-free Krylov force solve, as the JAX
package does (decoupledibpm.py:85, 211-215).

On a decomposed run every rank makes the full factor rows of the step's
windows (the dense blocks take them) and cuts its block's columns for E
and H (JAX ``rigidkinematics.py:96-122``); the refinement's residual is
summed over the group, so every rank takes the same branch.

The step's time is ``state["t"]``, a 0-d tensor of the solver's dtype on
its device, advanced as ``t + dt`` inside the step, as the JAX package
advances its scalar; it is re-seeded from the host's float64 ``self.t``
at init and in ``io_initial_data``.  So a float32 restart re-seeds t from
the file's float64 time and is not bit-exact against the uninterrupted
run (nor is the JAX package's).

Users subclass and override ``set_coordinates`` / ``set_velocity`` (the
reference's setCoordinatesBodies / setVelocityBodies); the built-in
``kinematics:`` node covers the in-line oscillating cylinder
(oscillatingcylinder.cpp:64-111):

  bodies:
    - type: points
      file: circle.body
      kinematics: {type: oscillation, f: 0.2, D: 1.0, KC: 5.0}
"""

from __future__ import annotations

import math
import os

import torch

from ..ibm.body import write_lagrangian_points
from ..ibm.interp import dense_ebnh_blocks
from ..linalg.fdm import make_fdm_solver
from ..linalg import loops
from ..linalg.krylov import _norm
from .decoupledibpm import DecoupledIBPMSolver, blocks_apply


class RigidKinematicsSolver(DecoupledIBPMSolver):
    def _extra_init(self, config: dict) -> None:
        super()._extra_init(config)
        self.coords0 = self._tensor(self.bodies.all_coords())
        self.state["t"] = self._tensor(self.t)
        self._kinematics = [node.get("kinematics")
                            for node in config.get("bodies", [])]

    def _refuse_kinematics(self, config: dict) -> None:
        """Moving bodies are this solver's to run."""

    def _make_dense_force_solver(self, fopts: dict) -> None:
        """The moving body's dense force solve (JAX decoupledibpm.py:174-209):
        refinement from the setup-time inverse against the matrix-free
        E B_N H of the step's windows, and where it exits above tolerance
        the direct solve of the step's dense blocks, reported as JAX's
        ``_result`` (:98-114): iters 0, the full matrix-free residual,
        convergence judged on the blocks' residual.  The choice is JAX's
        ``lax.cond``: the dense branch is a ``loops.cond`` on the
        refinement's ``~converged`` that writes into the refinement's
        result, so it runs on the device inside a chunk's graph; its
        solve is ``solve_ex`` (no host check of the factorisation)."""
        _, inverse = self._dense_force_blocks()
        ebnh, dim, dt = self._ebnh, self.mesh.dim, self.dt
        atol = float(fopts.get("atol", 1e-6))
        rtol = float(fopts.get("rtol", 0.0))
        refine = make_fdm_solver(inverse, ebnh, fopts)

        def solve_forces(rhsf, win, x0=None, full=None):
            res = refine(rhsf, torch.zeros_like(rhsf) if x0 is None else x0,
                         win)
            # replicated on a decomposed run (E sums the ranks' partials):
            # every rank takes the same branch
            fallback = ~res.converged

            def dense_solve():
                mats = dense_ebnh_blocks(win if full is None else full, dim,
                                         dt)
                df = torch.stack([torch.linalg.solve_ex(mats[c],
                                                        rhsf[:, c])[0]
                                  for c in range(dim)], dim=1)
                tol = torch.clamp(rtol * _norm(rhsf), min=atol)
                res.x.copy_(df)
                res.iters.zero_()
                res.residual.copy_(_norm(rhsf - ebnh(df, win)))
                res.converged.copy_(
                    _norm(rhsf - blocks_apply(mats, df)) <= tol)

            loops.cond(fallback, dense_solve,
                       (res.x, res.iters, res.residual, res.converged))
            res.fallback = fallback
            return res

        self._solve_forces = solve_forces

    @property
    def fallbacks(self) -> int:
        """Steps whose force solve fell back to the dense direct solve
        (each step's ``fallback`` stat, read at the flush)."""
        return sum(int(s.get("fallback", False)) for s in self.stats_history)

    def _step_stats(self, ctx: dict) -> dict:
        stats = super()._step_stats(ctx)
        if ctx["fsol"].fallback is not None:
            stats["fallback"] = ctx["fsol"].fallback
        return stats

    # -- user extension points (reference: rigidkinematics.h virtuals) ----
    def set_coordinates(self, t):
        """Body-point coordinates at time t (a 0-d tensor); default: the
        built-in kinematics of each body, else stationary."""
        out = [self.coords0[sl] + self._displacement(kin, t)
               for sl, kin in zip(self.bodies.slices(), self._kinematics)]
        return torch.cat(out, dim=0)

    def set_velocity(self, t):
        """Body-point velocities at time t (a 0-d tensor)."""
        out = [self._velocity(kin, t).expand(sl.stop - sl.start,
                                             self.mesh.dim)
               for sl, kin in zip(self.bodies.slices(), self._kinematics)]
        return torch.cat(out, dim=0)

    def _osc_params(self, kin):
        f = float(kin.get("f", 0.0))
        d = float(kin.get("D", 1.0))
        kc = float(kin.get("KC", 0.0))
        am = d * kc / (2.0 * math.pi)
        um = 2.0 * math.pi * f * am
        return f, am, um

    def _x_only(self, value):
        """(value, 0, ...) of the mesh's dimension."""
        zeros = torch.zeros(self.mesh.dim - 1, dtype=self.dtype,
                            device=self.device)
        return torch.cat([value.reshape(1).to(self.dtype), zeros])

    def _displacement(self, kin, t):
        if kin is None or kin.get("type", "static") == "static":
            return torch.zeros(self.mesh.dim, dtype=self.dtype,
                               device=self.device)
        if kin["type"] == "oscillation":
            # Xd = -Am sin(2 pi f t) in x (oscillatingcylinder.cpp:77-86)
            f, am, _ = self._osc_params(kin)
            return self._x_only(-am * torch.sin(2.0 * math.pi * f * t))
        raise ValueError(f"unknown kinematics type: {kin['type']}")

    def _velocity(self, kin, t):
        if kin is None or kin.get("type", "static") == "static":
            return torch.zeros(self.mesh.dim, dtype=self.dtype,
                               device=self.device)
        if kin["type"] == "oscillation":
            # Ux = -Um cos(2 pi f t) (oscillatingcylinder.cpp:93-103)
            f, _, um = self._osc_params(kin)
            return self._x_only(-um * torch.cos(2.0 * math.pi * f * t))
        raise ValueError(f"unknown kinematics type: {kin['type']}")

    # -- step wiring (moveBodies prepended, rigidkinematics.cpp:69-81) ----
    def _pre_step(self, state):
        return dict(state, t=state["t"] + self.dt)

    def _windows(self, state):
        X = self.set_coordinates(state["t"])
        # the window box is the whole grid (JAX's span for the windowed
        # engine): the step reads nothing to the host and keeps its
        # shapes, so a chunk of steps captures it
        full = self.delta.windows(X, whole=True)
        return full, self.delta.local_windows(full)

    def _body_velocity(self, state):
        return self.set_velocity(state["t"])

    # -- body output (writeBodies, rigidkinematics.cpp:162-183) -----------
    def io_initial_data(self) -> None:
        super().io_initial_data()
        self.state["t"] = self._tensor(self.t)
        self.write_bodies()

    def write(self) -> None:
        super().write()
        if self.ite % self.nsave == 0:
            self.write_bodies()

    def write_bodies(self) -> None:
        coords = self.set_coordinates(self._tensor(self.t)).cpu().numpy()
        for body, sl in zip(self.bodies.bodies, self.bodies.slices()):
            path = os.path.join(
                self.output_dir,
                f"{body.name}_{self.ite:07d}.{self.mesh.dim}D")
            write_lagrangian_points(path, coords[sl])
