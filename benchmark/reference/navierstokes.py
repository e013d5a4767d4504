"""Plain reference of the projection step of PetIBM's NavierStokesSolver,
with no body.

The fractional step of Perot (1993) on PetIBM's staggered, stretched
Cartesian grid, written from the method's equations in plain PyTorch,
with every solve direct (no refinement, no Krylov loop):

  1. rhs1 = u/dt - G p + (3/2 N(u^n) - 1/2 N(u^(n-1))) + nu/2 L u^n
            + nu/2 L_bc
  2. (I/dt - nu/2 L) u* = rhs1, by fast diagonalisation
  3. (D dt G) dP = D u* + D_bc, the right side's mean removed, by fast
     diagonalisation
  4. u = u* - dt G dP, p += dP, ghost values refreshed

N is the divergence-form convection with two-point face averages, L the
stretched-grid Laplacian, G and D the gradient and divergence (AB2 and
Crank-Nicolson, as ``ibpm.py`` writes them).  Each axis is periodic
(every component wraps: a component's points along its own axis include
the one on the upper face, whose lower image is the ghost) or walled by
Dirichlet faces, whose ghost points obey ``ghost = a0 * target + a1``
(PetIBM's singleboundarydirichlet.cpp); a face of any other kind is
refused.  Corner ghosts of the convection take a wall's a1 wrapped
along a periodic axis and copied from the edge along a walled one.
Each 1D operator is diagonalised on its own axis (a periodic one with
its wrap-around entries), so the solves are exact to rounding.

The pressure gauge: the Poisson right side's mean and dP's mean are
removed, each the plain mean over the cells (unweighted, as the port's
``poissonSolver.type: CPU`` does); the constant mode's eigenvalue is set
to 0 and its component dropped.  ``p`` keeps the mean it starts with.

``precision="float64"`` is the reference.  ``precision="tf32"`` is its
control: the same arithmetic in float32 with every matrix product's
operands rounded to TF32's 10-bit mantissa (round to nearest), which is
what a float32 matmul under TF32 tensor cores computes.

The state is a dict of tensors with the keys ``q`` ({"u", "v"[, "w"]}),
``p``, ``conv`` (the two newest -N(u), newest first) and ``bc``
("<component>_<face>" -> {"a1", "value"}, empty where every axis is
periodic); ``initial_state`` also gives ``dP`` and ``diff`` as zeros, the
keys of the port's ``NavierStokesSolver`` state.

Departures from PetIBM: none in the step.  The solves are direct where
PetIBM's are iterative to a tolerance, and only BN order 1, AB2 and
Crank-Nicolson are taken.
"""

from __future__ import annotations

import numpy as np
import torch

from .ibpm import FACES, NAMES, cell_widths, tf32


class _Line:
    """One velocity component's gridline along one direction: interior
    coordinates and widths, the ghost points' coordinates at both ends
    (a periodic axis's ghosts are the images of the points at the other
    end)."""

    def __init__(self, dxp: np.ndarray, lo: float, same: bool,
                 periodic: bool):
        verts = lo + np.cumsum(dxp)
        hi = verts[-1]
        if same and periodic:  # points on every cell's upper face
            self.coord = np.concatenate(([lo], verts, [hi + dxp[0]]))
            self.dl = 0.5 * (dxp + np.roll(dxp, -1))
        elif same:  # points on the interior faces, ghosts on the walls
            self.coord = np.concatenate(([lo], verts))
            self.dl = 0.5 * (dxp[:-1] + dxp[1:])
        else:  # cell centres; ghosts the images or mirrored across walls
            centres = verts - 0.5 * dxp
            below, above = ((dxp[-1], dxp[0]) if periodic
                            else (dxp[0], dxp[-1]))
            self.coord = np.concatenate(([lo - 0.5 * below], centres,
                                         [hi + 0.5 * above]))
            self.dl = dxp.copy()
        self.n = len(self.dl)
        self.periodic = periodic
        self.dneg = self.coord[1:-1] - self.coord[:-2]
        self.dpos = self.coord[2:] - self.coord[1:-1]

    def stiffness(self, a0_lo: float = 0.0, a0_hi: float = 0.0):
        """The 1D Laplacian times the widths, W L, symmetric: -(1/dneg +
        1/dpos) on the diagonal, the neighbours' 1/dneg and 1/dpos beside
        it, wrapped on a periodic axis; a wall's ghost relation folded
        into the end rows by its a0."""
        cn, cp = 1.0 / self.dneg, 1.0 / self.dpos
        K = np.diag(-(cn + cp)) + np.diag(cn[1:], -1) + np.diag(cp[:-1], 1)
        if self.periodic:
            K[0, -1] += cn[0]
            K[-1, 0] += cp[-1]
        else:
            K[0, 0] += cn[0] * a0_lo
            K[-1, -1] += cp[-1] * a0_hi
        return K


class NavierStokes:
    """The reference step on one bodyless case (``config``: a solver
    config dict with ``mesh``, ``flow`` and ``parameters``; ``body``: must
    be None)."""

    def __init__(self, config: dict, body=None, *, device,
                 precision: str = "float64"):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision {precision!r}: float64 or tf32")
        if body is not None or config.get("bodies"):
            raise ValueError("the Navier-Stokes reference takes no body")
        self.device = torch.device(device)
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64
        mesh = config["mesh"]
        self.dim = len(mesh)
        order = {"x": 0, "y": 1, "z": 2}
        self.dxp, self.lo = [None] * self.dim, [0.0] * self.dim
        for ax in mesh:
            d = order[ax["direction"]]
            self.dxp[d] = cell_widths(ax["start"], ax["subDomains"])
            self.lo[d] = float(ax["start"])
        params = config["parameters"]
        self.dt = float(params["dt"])
        self.nu = float(config["flow"]["nu"])
        for key, want in (("convection", "ADAMS_BASHFORTH_2"),
                          ("diffusion", "CRANK_NICOLSON")):
            if params.get(key, want) != want:
                raise ValueError(f"the reference steps {key} by {want}")
        if int(params.get("BN", 1)) != 1:
            raise ValueError("the reference takes BN order 1")
        if (params.get("poissonSolver") or {}).get("type", "CPU") != "CPU":
            raise ValueError("the reference removes the pressure's mean "
                             "(poissonSolver.type CPU), it pins no entry")
        self._faces(config["flow"]["boundaryConditions"])
        self.lines = [[_Line(self.dxp[d], self.lo[d], c == d,
                             self.periodic[d])
                       for d in range(self.dim)] for c in range(self.dim)]
        self._built = False

    def _faces(self, bcs: list) -> None:
        """Which axes are periodic, and each walled (component, face): its
        value and a0."""
        table = {}
        for entry in bcs:
            for key, val in entry.items():
                if key != "location":
                    table[(key, entry["location"])] = (str(val[0]),
                                                       float(val[1]))
        self.periodic, self.face = [], {}
        for d in range(self.dim):
            kinds = {table[(NAMES[c], FACES[k])][0]
                     for c in range(self.dim) for k in (2 * d, 2 * d + 1)}
            if "PERIODIC" in kinds and kinds != {"PERIODIC"}:
                raise ValueError(f"axis {'xyz'[d]}: periodic for every "
                                 "component on both faces, or for none")
            self.periodic.append(kinds == {"PERIODIC"})
            if self.periodic[d]:
                continue
            for c in range(self.dim):
                for k in (2 * d, 2 * d + 1):
                    kind, value = table[(NAMES[c], FACES[k])]
                    if kind != "DIRICHLET":
                        raise ValueError(f"{NAMES[c]} at {FACES[k]}: the "
                                         "reference covers PERIODIC axes "
                                         "and DIRICHLET faces")
                    self.face[(c, k)] = {
                        "value": value, "same": c == d,
                        "a0": 0.0 if c == d else -1.0,
                        "key": f"{NAMES[c]}_{FACES[k]}"}

    def _build(self) -> None:
        """The operators and the solves' transforms: at the first step
        (``initial_state`` needs none)."""
        if not self._built:
            self._operators()
            self._built = True

    # ------------------------------------------------------------------
    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), dtype=self.dtype,
                               device=self.device)

    def axis(self, d: int) -> int:
        return self.dim - 1 - d

    def _bcast(self, vec: np.ndarray, d: int) -> torch.Tensor:
        shape = [1] * self.dim
        shape[self.axis(d)] = len(vec)
        return self._t(np.asarray(vec).reshape(shape))

    def shape(self, c: int) -> tuple:
        """Array shape of component ``c`` (z, y, x order); c = dim is p."""
        if c == self.dim:
            return tuple(len(self.dxp[d]) for d in reversed(range(self.dim)))
        return tuple(self.lines[c][d].n for d in reversed(range(self.dim)))

    def _operators(self) -> None:
        dim = self.dim
        self.cneg = [[self._bcast(1.0 / (ln.dneg * ln.dl), d)
                      for d, ln in enumerate(self.lines[c])]
                     for c in range(dim)]
        self.cpos = [[self._bcast(1.0 / (ln.dpos * ln.dl), d)
                      for d, ln in enumerate(self.lines[c])]
                     for c in range(dim)]
        self.inv_dl = [[self._bcast(1.0 / ln.dl, d)
                        for d, ln in enumerate(self.lines[c])]
                       for c in range(dim)]
        self.area = []
        for c in range(dim):
            area = torch.ones([1] * dim, dtype=self.dtype, device=self.device)
            for d in range(dim):
                if d != c:
                    area = area * self._bcast(self.dxp[d], d)
            self.area.append(area)
        # the momentum solve: per component and direction, the 1D
        # homogeneous Laplacian diagonalised
        self.helm = []
        for c in range(dim):
            eig, vecs = [], []
            for d in range(dim):
                ln = self.lines[c][d]
                a0 = [self.face[(c, k)]["a0"] if (c, k) in self.face else 0.0
                      for k in (2 * d, 2 * d + 1)]
                lam, V, Vi = self._diagonalise(ln.stiffness(*a0), ln.dl)
                eig.append(self._bcast(lam, d))
                vecs.append((V, Vi))
            denom = 1.0 / self.dt - 0.5 * self.nu * sum(eig)
            self.helm.append((vecs, 1.0 / denom))
        # the pressure solve: D dt G = dt (prod W) sum_d W_d^-1 K_d, K_d the
        # stiffness between cell centres (Neumann at a wall, wrapped on a
        # periodic axis)
        eig, vecs = [], []
        for d in range(dim):
            dxp = self.dxp[d]
            g = 1.0 / self.lines[d][d].dl  # one a face, cell i to i + 1
            K = np.zeros((len(dxp), len(dxp)))
            for i in range(len(g)):
                j = (i + 1) % len(dxp)
                K[i, i] -= g[i]
                K[j, j] -= g[i]
                K[i, j] += g[i]
                K[j, i] += g[i]
            lam, V, Vi = self._diagonalise(K, dxp)
            lam[np.argmin(np.abs(lam))] = 0.0  # the constant mode
            eig.append(self._bcast(lam, d))
            vecs.append((V, Vi))
        total = sum(eig)
        inv = torch.where(total == 0, torch.zeros_like(total),
                          1.0 / torch.where(total == 0,
                                            torch.ones_like(total), total))
        vol = torch.ones([1] * dim, dtype=self.dtype, device=self.device)
        for d in range(dim):
            vol = vol * self._bcast(self.dxp[d], d)
        self.poisson = (vecs, inv, self.dt * vol)

    def _diagonalise(self, K: np.ndarray, w: np.ndarray) -> tuple:
        """W^-1 K, K symmetric and W = diag(w) > 0, as V diag(lam) V^-1
        with V = W^-1/2 Q, V^-1 = Q^T W^1/2 (Q from the symmetric
        W^-1/2 K W^-1/2), in float64."""
        s = np.sqrt(w)
        lam, Q = np.linalg.eigh((K / s[:, None]) / s[None, :])
        return lam, self._t(Q / s[:, None]), self._t(Q.T * s[None, :])

    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = tf32(a), tf32(b)
        return a @ b

    def _along(self, M: torch.Tensor, x: torch.Tensor, d: int):
        """M applied along direction d of x."""
        ax = self.axis(d)
        y = torch.movedim(x, ax, -1)
        out = self._mm(y.reshape(-1, y.shape[-1]), M.T)
        return torch.movedim(out.reshape(y.shape[:-1] + (M.shape[0],)), -1,
                             ax)

    def _fast_solve(self, vecs, scale, b):
        y = b
        for d in range(self.dim):
            y = self._along(vecs[d][1], y, d)
        y = y * scale
        for d in range(self.dim):
            y = self._along(vecs[d][0], y, d)
        return y

    # ------------------------------------------------------------------
    def _edge(self, x, d: int, side: int):
        ax = self.axis(d)
        return x.narrow(ax, x.shape[ax] - 1 if side else 0, 1)

    def _ghosts(self, c, x, d, bc, done=()):
        """The two ghost layers of x along direction d: the images on a
        periodic axis; ``a0 * edge + a1`` at a wall (``bc`` None: a1 = 0),
        a1 lifted over the directions ``done`` (already padded: wrapped
        on a periodic axis, the edge copied at a wall)."""
        if self.periodic[d]:
            return self._edge(x, d, 1), self._edge(x, d, 0)
        out = []
        for side in (0, 1):
            face = self.face[(c, 2 * d + side)]
            g = face["a0"] * self._edge(x, d, side)
            if bc is not None:
                a1 = bc[face["key"]]["a1"].unsqueeze(self.axis(d))
                for dp in done:
                    lo, hi = (self._edge(a1, dp, 1), self._edge(a1, dp, 0)
                              ) if self.periodic[dp] else (
                        self._edge(a1, dp, 0), self._edge(a1, dp, 1))
                    a1 = torch.cat([lo, a1, hi], dim=self.axis(dp))
                g = g + a1
            out.append(g)
        return tuple(out)

    def _pad_line(self, c, x, d, bc):
        """x with one ghost layer on both ends of direction d."""
        lo, hi = self._ghosts(c, x, d, bc)
        return torch.cat([lo, x, hi], dim=self.axis(d))

    def _pad_all(self, c, x, bc):
        """x with ghost layers in every direction (x first), corners
        included."""
        out = x
        for d in range(self.dim):
            lo, hi = self._ghosts(c, out, d, bc, done=range(d))
            out = torch.cat([lo, out, hi], dim=self.axis(d))
        return out

    def laplacian(self, q: dict, bc) -> dict:
        out = {}
        for c in range(self.dim):
            f, total = q[NAMES[c]], 0.0
            for d in range(self.dim):
                ax, n = self.axis(d), f.shape[self.axis(d)]
                ext = self._pad_line(c, f, d, bc)
                total = total + (self.cneg[c][d] * (ext.narrow(ax, 0, n) - f)
                                 + self.cpos[c][d] * (ext.narrow(ax, 2, n)
                                                      - f))
            out[NAMES[c]] = total
        return out

    def convection(self, q: dict, bc: dict) -> dict:
        ext = [self._pad_all(c, q[NAMES[c]], bc) for c in range(self.dim)]

        def win(e, shape, offsets):
            idx = []
            for ax in range(e.ndim):
                off = offsets.get(self.dim - 1 - ax, 0)
                idx.append(slice(1 + off, 1 + off + shape[ax]))
            return e[tuple(idx)]

        out = {}
        for c in range(self.dim):
            shape, total = q[NAMES[c]].shape, 0.0
            for d in range(self.dim):
                lo = 0.5 * (win(ext[c], shape, {d: -1})
                            + win(ext[c], shape, {d: 0}))
                hi = 0.5 * (win(ext[c], shape, {d: 0})
                            + win(ext[c], shape, {d: 1}))
                if d == c:
                    term = hi * hi - lo * lo
                else:
                    adv_lo = 0.5 * (win(ext[d], shape, {d: -1, c: 0})
                                    + win(ext[d], shape, {d: -1, c: 1}))
                    adv_hi = 0.5 * (win(ext[d], shape, {d: 0, c: 0})
                                    + win(ext[d], shape, {d: 0, c: 1}))
                    term = adv_hi * hi - adv_lo * lo
                total = total + term * self.inv_dl[c][d]
            out[NAMES[c]] = total
        return out

    def divergence(self, q: dict, bc) -> torch.Tensor:
        """Per cell, the sum over directions of the face area times the
        upper face's component less the lower's (the lower face of the
        first cell: the wall's ghost, or the periodic image)."""
        out = 0.0
        for c in range(self.dim):
            ax, n = self.axis(c), len(self.dxp[c])
            ext = self._pad_line(c, q[NAMES[c]], c, bc)
            out = out + (ext.narrow(ax, 1, n) - ext.narrow(ax, 0, n)
                         ) * self.area[c]
        return out

    def gradient(self, p: torch.Tensor) -> dict:
        out = {}
        for c in range(self.dim):
            ax, n = self.axis(c), self.lines[c][c].n
            ext = torch.cat([p, self._edge(p, c, 0)], dim=ax)
            out[NAMES[c]] = (ext.narrow(ax, 1, n) - ext.narrow(ax, 0, n)
                             ) * self.inv_dl[c][c]
        return out

    # ------------------------------------------------------------------
    def initial_bc(self, q: dict) -> dict:
        """The ghost state at the start: each Dirichlet face's a1 from its
        value."""
        bc = {}
        for (c, k), face in self.face.items():
            target = self._edge(q[NAMES[c]], k // 2, k % 2).squeeze(
                self.axis(k // 2))
            v = face["value"] if face["same"] else 2.0 * face["value"]
            a1 = torch.full_like(target, v)
            bc[face["key"]] = {"a1": a1, "value": face["a0"] * target + a1}
        return bc

    def _refresh_ghosts(self, bc: dict, q: dict) -> dict:
        new = {}
        for (c, k), face in self.face.items():
            st = bc[face["key"]]
            target = self._edge(q[NAMES[c]], k // 2, k % 2).squeeze(
                self.axis(k // 2))
            new[face["key"]] = {"a1": st["a1"],
                                "value": face["a0"] * target + st["a1"]}
        return new

    # ------------------------------------------------------------------
    def step(self, st: dict) -> dict:
        """One time step of the state dict (module docstring)."""
        self._build()
        dt, nu, names = self.dt, self.nu, NAMES[:self.dim]
        q, p, bc = st["q"], st["p"], st["bc"]
        gp = self.gradient(p)
        nq = self.convection(q, bc)
        conv = ({k: -nq[k] for k in names}, st["conv"][0])
        lq = self.laplacian(q, bc)
        zero = {k: torch.zeros_like(q[k]) for k in names}
        corr = self.laplacian(zero, bc)
        rhs1 = {k: q[k] / dt - gp[k] + 1.5 * conv[0][k] - 0.5 * conv[1][k]
                + 0.5 * nu * lq[k] + 0.5 * nu * corr[k] for k in names}
        ustar = {names[c]: self._fast_solve(self.helm[c][0], self.helm[c][1],
                                            rhs1[names[c]])
                 for c in range(self.dim)}
        rhs2 = self.divergence(ustar, bc)
        rhs2 = rhs2 - rhs2.mean()
        vecs, inv, dt_vol = self.poisson
        dP = self._fast_solve(vecs, inv, rhs2 / dt_vol)
        dP = dP - dP.mean()
        gdp = self.gradient(dP)
        qn = {k: ustar[k] - dt * gdp[k] for k in names}
        return {"q": qn, "p": p + dP, "conv": conv,
                "bc": self._refresh_ghosts(bc, qn)}

    def advance(self, st: dict, steps: int) -> dict:
        for _ in range(steps):
            st = self.step(st)
        return st

    # ------------------------------------------------------------------
    def load(self, tree: dict) -> dict:
        """The keys the step reads from a state of numpy arrays (a
        solver's state, or ``initial_state``'s), as tensors here."""
        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                   device=self.device)

        names = NAMES[:self.dim]
        return {"q": {k: t(tree["q"][k]) for k in names}, "p": t(tree["p"]),
                "conv": tuple({k: t(h[k]) for k in names}
                              for h in tree["conv"][:2]),
                "bc": {k: {"a1": t(v["a1"]), "value": t(v["value"])}
                       for k, v in tree["bc"].items()}}

    def initial_state(self, fields: dict) -> dict:
        """The whole state at step 0 from the fields (numpy float64):
        velocity, and ``p`` where given (else zero); dP and the histories
        zero, the ghost state from the velocity.  Numpy leaves; the keys
        of a Navier-Stokes solver's state."""
        names = NAMES[:self.dim]
        q = {k: np.asarray(fields[k], np.float64) for k in names}
        bc = self.initial_bc({k: torch.as_tensor(v) for k, v in q.items()})
        zeros = {k: np.zeros(self.shape(c)) for c, k in enumerate(names)}
        p0 = np.asarray(fields.get("p", np.zeros(self.shape(self.dim))),
                        np.float64)
        return {"q": q, "p": p0, "dP": np.zeros(self.shape(self.dim)),
                "conv": (dict(zeros), dict(zeros)), "diff": (dict(zeros),),
                "bc": {k: {"a1": v["a1"].numpy(), "value": v["value"].numpy()}
                       for k, v in bc.items()}}
