"""Fully coupled immersed-boundary projection method (Taira & Colonius
2007).

Counterpart of ``petibm_tpu/solvers/ibpm.py`` (reference:
applications/ibpm/ibpm.{h,cpp}).  The Lagrangian forces join the
pressure in one unknown, the dict {"p": pressure, "f": forces}, and the
block operator

    M [p, f] = [ D B_N (G p - H f),  E B_N (G p - H f) ]

is applied matrix-free (G and D stencils, E and H the delta factor
matrices).  M is symmetric negative semidefinite with the constant
pressure as its nullspace (ibpm.cpp:242-283), so CG applies to -M.

One step: the momentum RHS gains + H f; u*; the right side
[D u* + Dbc; E u*] (mean removed, or entry 0 of the pressure set to 0
when pinned); the coupled solve for dPhi = {dp, df}, warm-started from
the last one; u = u* - B_N (G dp - H df), p += dp, f += df.

The coupled solve, as the JAX package chooses it:
- BN order 1, factor windows and pc mg or fdm (unless ``coupledDirect:
  false``): the
  setup-time Schur complement of the force block, formed column by column
  through the FDM pressure solve and inverted on the host in float64; CG
  preconditioned by that exact block inverse (``coupledMode: pcg``, the
  default) or its refinement (``coupledMode: direct``).  The pinned
  pressure (``poissonSolver.type: GPU``) wraps it in ``PinnedSolve``;
- otherwise CG on -M preconditioned per block: the pressure block by the
  V-cycle (its level-0 residual the CUDA kernel K1, BN order 1 and not
  pinned), the FDM pseudo-inverse or a probed Jacobi diagonal; the force
  block by the dense inverted (N, N) EBNH blocks (BN order 1 and factor
  windows) or the analytic diagonal of E B1 H (BN > 1 or the windowed
  delta engine, whose windows hold no factor rows).

On a decomposed run (JAX ``ibpm.py:97-101``) there is no direct solve:
CG on -M runs with the pressure block on the decomposed FDM
pseudo-inverse, or on the decomposed V-cycle for the pinned pressure,
and the force block's exact inverse from the full factor rows every
rank holds; E and H take the rank's columns, and the inner products sum
the pressure's partials over the group and count the replicated forces
once (``linalg/krylov.py``'s ``_dot``).

A restart file carries ``force``, ``dP`` and ``dF`` (dPhi, the coupled
solve's warm start) and the BC ghost state (JAX ``ibpm.py:443-468``).
The step is ``_profile_phases`` chained (JAX ``ibpm.py:392-441``), the
stages the stage profiler times (``utils/profiling.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import solver_config
from ..ibm.body import BodyPack
from ..ibm.interp import dense_ebnh_blocks, make_delta_op
from ..linalg.fdm import (FastDiagPoisson, PinnedSolve, holds_first,
                          make_fdm_solver, pinned_operator, set_first)
from ..linalg.krylov import make_solver, tmap
from ..linalg.probe_diag import extract_diagonal
from ..operators.cuda_stencil import make_cuda_poisson
from ..types import Field
from ._forceslog import ForcesLogMixin
from .navierstokes import NavierStokesSolver

#: the Schur columns formed in one batch are capped near 2^25 cells (128 MB
#: a field in float32), at most 64 columns (JAX ``ibpm.py:160-170``)
_SCHUR_CELLS = 1 << 25
_SCHUR_CHUNK = 64


class IBPMSolver(ForcesLogMixin, NavierStokesSolver):
    _skip_base_poisson = True  # the {p, f} block system replaces p_solver

    def _extra_init(self, config: dict) -> None:
        self.bodies = BodyPack(config, self.mesh)
        if self.bodies.n_bodies == 0:
            raise ValueError("IBPM requires at least one body")
        params = config.get("parameters", {})
        self.delta = make_delta_op(
            self.mesh, params.get("delta", "ROMA_ET_AL_1999"),
            dtype=self.dtype, device=self.device, n_pts=self.bodies.n_pts,
            engine=params.get("deltaEngine", "auto"))
        if self.part is not None:
            self.delta.set_mesh(self.part)
        self.state["f"] = torch.zeros((self.bodies.n_pts, self.mesh.dim),
                                      dtype=self.dtype, device=self.device)
        # the force block's inverse takes the full factor rows, E and H
        # the rank's columns (as the decoupled solver keeps them)
        self._full_windows = self.delta.windows(
            torch.as_tensor(self.bodies.all_coords(), dtype=self.dtype,
                            device=self.device))
        self._win = self.delta.local_windows(self._full_windows)
        self._create_coupled_poisson(config)
        self.state["dPhi"] = {"p": torch.zeros_like(self.state["p"]),
                              "f": torch.zeros_like(self.state["f"])}

    # ------------------------------------------------------------------
    def _create_coupled_poisson(self, config: dict) -> None:
        """The modified Poisson operator and its solver, in place of the
        pressure-only system (createOperators, ibpm.cpp:184-197)."""
        delta, win, bn = self.delta, self._win, self.bn
        grad, div = self.grad, self.div
        popts = solver_config(config, "poisson")
        self.is_ref_p = popts.get("backend") == "GPU"

        def G_combined(phi):
            return tmap(lambda a, b: a - b, grad(phi["p"]),
                        delta.spread(phi["f"], win))

        def M(phi):
            w = bn(G_combined(phi))
            return {"p": div(w, None, homogeneous=True),
                    "f": delta.interpolate(w, win)}

        A_p = pinned_operator(M, "p", part=self.part) if self.is_ref_p \
            else M

        def negM(phi):
            return tmap(lambda x: -x, A_p(phi))

        self._G_combined = G_combined

        # the direct Schur-complement solve for BN order 1: the pressure
        # block -D B1 G has the exact FDM inverse, so the block system is
        # solved through a setup-time dense force-space Schur complement;
        # not on a decomposed run, which takes the outer CG (JAX
        # ibpm.py:97-101)
        params = config.get("parameters", {})
        use_direct = (self.bn_order == 1 and not self.delta.windowed
                      and self.part is None
                      and popts.get("pc", "mg") in ("mg", "fdm")
                      and bool(params.get("coupledDirect", True)))
        if use_direct and self.is_ref_p:
            # the pinned system is the projected Schur solve with a
            # compatibility shift and a gauge fix (PinnedSolve); it builds
            # the FDM solve even under fdm: false, since the outer CG on
            # the pinned system stalls (the 450^2 case diverged at 20000
            # iterations in the JAX package), with the FFT default on
            # periodic uniform axes (JAX ibpm.py:115)
            self.poisson_fdm = FastDiagPoisson(
                self.mesh.dxp, self.mesh.periodic, dtype=self.dtype,
                device=self.device, scale=self.dt)
            self._coupled_solver = self._build_schur_solver(negM, popts)
            return
        p_pre = self._make_poisson_pc(popts) if use_direct else None
        if getattr(self, "poisson_fdm", None) is not None:
            self._coupled_solver = self._build_schur_solver(negM, popts)
            return
        self._finish_cg_solver(config, popts, negM, p_pre)

    # ------------------------------------------------------------------
    def _schur_matrix(self) -> np.ndarray:
        """The force-space Schur complement in host float64, symmetrised:

            S = E B1 H + (E B1 G) A_pp^+ (D B1 H),  A_pp = -D B1 G,

        each column formed from a unit force by the FDM pressure solve, in
        the solver's dtype; columns go through ``torch.func.vmap`` in
        chunks (the operators see one unbatched field each)."""
        fdm = self.poisson_fdm
        delta, win, bn = self.delta, self._win, self.bn
        grad, div = self.grad, self.div
        N, dim = self.bodies.n_pts, self.mesh.dim
        m = N * dim

        def col(e_flat):
            f = e_flat.reshape(N, dim)
            h = bn(delta.spread(f, win))                    # B1 H e
            a = delta.interpolate(h, win)                   # E B1 H e
            y = fdm.solve(div(h, None, homogeneous=True))   # A_pp^+ D B1 H e
            s2 = delta.interpolate(bn(grad(y)), win)        # E B1 G y
            return (a + s2).reshape(-1)

        ncells = int(np.prod(self.state["p"].shape))
        chunk = max(1, min(_SCHUR_CHUNK, _SCHUR_CELLS // max(ncells, 1)))
        eye = torch.eye(m, dtype=self.dtype, device=self.device)
        cols = torch.cat([torch.func.vmap(col)(eye[k:k + chunk])
                          for k in range(0, m, chunk)])
        S = cols.cpu().numpy().astype(np.float64).T
        # the coupled operator is symmetric, hence so is S; averaging
        # halves the float32 column noise before the inversion
        return 0.5 * (S + S.T)

    def _build_schur_solver(self, negM, popts: dict):
        """Setup-time block elimination of the coupled system
        (``ibpm.py:131-245``).  With A_pf = D B1 H and A_fp = -E B1 G, a
        solve is one FDM pressure solve, two small dense matvecs (S^-1) and
        one FDM correction solve.  The constant pressure nullspace is
        consistent with the elimination: every A_pf column is sum-free and
        A_fp annihilates constants."""
        fdm = self.poisson_fdm
        delta, win, bn = self.delta, self._win, self.bn
        grad, div = self.grad, self.div
        N, dim = self.bodies.n_pts, self.mesh.dim
        Sinv = torch.as_tensor(np.linalg.inv(self._schur_matrix()),
                               dtype=self.dtype, device=self.device)

        class _Schur:
            @staticmethod
            def solve(r):
                y = fdm.solve(r["p"])
                g = r["f"].reshape(-1) + delta.interpolate(
                    bn(grad(y)), win).reshape(-1)
                f2 = (Sinv @ g).reshape(N, dim)
                dp = fdm.solve(r["p"] - div(
                    bn(delta.spread(f2, win)), None, homogeneous=True))
                return {"p": dp, "f": f2}

        schur = PinnedSolve(_Schur, "p") if self.is_ref_p else _Schur
        mode = str(self.config.get("parameters", {}).get("coupledMode",
                                                          "pcg"))
        if mode == "direct":
            # plain refinement: its float32 recurrence floor can sit above
            # atol on large grids, hence the CG default below
            return make_fdm_solver(schur, negM, popts)
        if self.is_ref_p:
            # the pinned system is nonsingular: no mean removal
            M_pre = schur.solve
        else:
            def M_pre(r):
                out = schur.solve(r)
                return {"p": out["p"] - torch.mean(out["p"]), "f": out["f"]}

        return make_solver(negM, popts, M=M_pre)

    # ------------------------------------------------------------------
    def _finish_cg_solver(self, config: dict, popts: dict, negM,
                          p_pre) -> None:
        """CG on -M with a block preconditioner (``ibpm.py:248-335``): BN
        > 1, the windowed delta engine, ``coupledDirect: false``, ``fdm:
        false``, a pc other than mg and fdm, or a decomposed run (the
        pressure block on the decomposed FDM or V-cycle, the force block
        from the full windows, every inner product summed over the group
        with the replicated forces counted once)."""
        win, bn, mean = self._full_windows, self.bn, self._mean
        pc = popts.get("pc", "mg")
        if pc in ("mg", "fdm"):
            if p_pre is None:
                p_pre = self._make_poisson_pc(popts)
            fdm_p = getattr(self, "poisson_fdm", None)
            if p_pre is None and fdm_p is not None:
                # the FDM pseudo-inverse of the pressure block, its output
                # mean removed
                def p_pre(r):
                    out = fdm_p.solve(r)
                    return out - mean(out)
            # the coupled operator is not K1 (the force term enters
            # between G and D), but the V-cycle's level-0 residual is the
            # plain pressure operator: K1 there
            if (not self.is_ref_p and self.bn_order == 1
                    and getattr(self, "poisson_mg", None) is not None
                    and self.part is None
                    and not bool(config.get("parameters", {}).get(
                        "disablePallas", False))):
                fused = make_cuda_poisson(self.poisson_mg.levels[0])
                if fused is not None:
                    self.poisson_mg.set_fused_apply(fused)
        else:
            diag_p = extract_diagonal(
                lambda p: -self.div(bn(self.grad(p)), None, homogeneous=True),
                torch.zeros_like(self.state["p"]), radius=self.bn_order,
                **self._diag_layout(Field.P))

            def p_pre(r):
                return r / diag_p
        dim = self.mesh.dim
        if self.bn_order == 1 and not self.delta.windowed:
            # the exact inverse of the force block: dense per-component
            # (N, N) E B1 H blocks inverted once on the host in float64
            inv_f = [torch.as_tensor(
                np.linalg.inv(m.cpu().numpy().astype(np.float64)),
                dtype=self.dtype, device=self.device)
                for m in dense_ebnh_blocks(win, dim, self.dt)]

            def M_block(r):
                rf = r["f"]
                return {"p": p_pre(r["p"]),
                        "f": torch.stack([inv_f[c] @ rf[:, c]
                                          for c in range(dim)], dim=1)}
        else:
            # the analytic order-1 diagonal, diag(E B1 H) =
            # dt * prod_d sum_k sd * sv (the same in both window layouts)
            cols = []
            for c in range(dim):
                prod = None
                for d in range(dim):
                    s = torch.sum(win[c]["sd"][d] * win[c]["sv"][d], dim=1)
                    prod = s if prod is None else prod * s
                cols.append(self.dt * prod)
            diag_f = torch.clamp(torch.stack(cols, dim=1), min=1e-30)

            def M_block(r):
                return {"p": p_pre(r["p"]), "f": r["f"] / diag_f}

        self._coupled_solver = make_solver(
            negM, popts, M=M_block if pc != "none" else None,
            reduce=self._reduce)

    # ------------------------------------------------------------------
    def _step_stats(self, ctx: dict) -> dict:
        # the coupled solve's stats stand as the pressure solve's; forces
        # ride along for the forces log
        return dict(super()._step_stats(ctx), f=ctx["state"]["f"])

    # ------------------------------------------------------------------
    def _profile_phases(self):
        """The coupled step's stages (JAX ``ibpm.py:392-441``): the
        momentum RHS gains + H f (the reference's combined gradient [G, -H]
        on phi = (p, f), ibpm.cpp:164-169); the combined {p, f} system
        fills the rhsPoisson (the right side [D u* + Dbc; E u*],
        ibpm.cpp:286-313) and solvePoisson stages; the update projects
        u -= B_N (G dp - H df) and adds dphi to (p, f)."""
        ns = dict(super()._profile_phases())

        def rhsVelocity(ctx):
            rhs1, state = self._rhs_velocity(ctx["state"])
            hf = self.delta.spread(state["f"], self._win)
            return dict(ctx, state=state,
                        rhs1=tmap(lambda r, x: r + x, rhs1, hf))

        def rhsPoisson(ctx):
            state, ustar = ctx["state"], ctx["ustar"]
            rhs_p = self.div(ustar, state["bc"])
            rhs_f = self.delta.interpolate(ustar, self._win)
            if self.is_ref_p:
                if holds_first(self.part):
                    rhs_p = set_first(rhs_p.reshape(-1),
                                      0.0).reshape(rhs_p.shape)
            else:
                rhs_p = rhs_p - self._mean(rhs_p)
            return dict(ctx, rhs={"p": -rhs_p, "f": -rhs_f})

        def solvePoisson(ctx):
            state = ctx["state"]
            phi0 = (state["dPhi"] if self.warm_start_poisson
                    else tmap(torch.zeros_like, state["dPhi"]))
            psol = self._coupled_solver(ctx["rhs"], phi0)
            return dict(ctx, psol=psol, dphi=psol.x)

        def update(ctx):
            state, dphi = ctx["state"], ctx["dphi"]
            if not self.is_ref_p:
                dphi = dict(dphi, p=dphi["p"] - self._mean(dphi["p"]))
            qnew = tmap(lambda u, g: u - g, ctx["ustar"],
                        self.bn(self._G_combined(dphi)))
            bc = self.bc.update_ghost_values(state["bc"], qnew)
            return dict(ctx, state=dict(state, q=qnew,
                                        p=state["p"] + dphi["p"],
                                        f=state["f"] + dphi["f"], bc=bc,
                                        dPhi=dphi))

        return [("rhsVelocity", rhsVelocity),
                ("solveVelocity", ns["solveVelocity"]),
                ("rhsPoisson", rhsPoisson),
                ("solvePoisson", solvePoisson),
                ("update", update)]

    # ------------------------------------------------------------------
    def _restart_extra(self) -> dict:
        # the base class's dP is replaced by dPhi's; the BC ghost state
        # stays
        return dict({"force": self.state["f"],
                     "dP": self._gather(self.state["dPhi"]["p"], Field.P),
                     "dF": self.state["dPhi"]["f"]},
                    **self._bc_restart_extra())

    def _read_restart_extra(self, extra: dict) -> None:
        fshape = (self.bodies.n_pts, self.mesh.dim)
        if "force" in extra:
            self.state["f"] = self._tensor(extra["force"].reshape(fshape))
        if "dP" in extra and "dF" in extra:
            self.state["dPhi"] = {
                "p": self._field(extra["dP"].reshape(
                    self.mesh.shape(Field.P)), Field.P),
                "f": self._tensor(extra["dF"].reshape(fshape))}
        self._restore_bc_extra(extra)
