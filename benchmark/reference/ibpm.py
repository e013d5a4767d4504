"""Plain reference of the decoupled immersed-boundary projection step.

The step of Li et al. (2016) on PetIBM's staggered, stretched Cartesian
grid, written from the method's equations in plain PyTorch, with every
solve direct (no refinement, no Krylov loop):

  1. rhs1 = u/dt - G p + (3/2 N(u^n) - 1/2 N(u^(n-1))) + nu/2 L u^n
            + nu/2 L_bc(after the convective update) + H f
  2. (I/dt - nu/2 L) u* = rhs1, by fast diagonalisation
  3. (dt E H) df = -E u*, dense per velocity component
  4. u** = u* + dt H df
  5. (D dt G) dP = D u** + D_bc (mean removed), by fast diagonalisation,
     dP's mean removed
  6. u = u** - dt G dP, p += dP, f += df, ghost values refreshed

N is the divergence-form convection with two-point face averages, L the
stretched-grid Laplacian, G and D the gradient and divergence; the
Dirichlet and convective-outflow boundaries act through ghost points
``ghost = a0 * target + a1`` (PetIBM's singleboundary*.cpp).  E and H
interpolate and spread with the Roma et al. (1999) three-point kernel
of the width of the grid cell at the first body point.

``precision="float64"`` is the reference.  ``precision="tf32"`` is its
control: the same arithmetic in float32 with every matrix product's
operands rounded to TF32's 10-bit mantissa (round to nearest), which is
what a float32 matmul under TF32 tensor cores computes; the dense force
solve runs in float32.

The state is a dict of tensors with the keys ``q`` ({"u", "v"[, "w"]}),
``p``, ``f`` ((points, dim)), ``conv`` (the two newest -N(u), newest
first) and ``bc`` ("<component>_<face>" -> {"a1", "value"}).  Only
Dirichlet and convective faces on a walled (non-periodic) box are
covered: the two configurations this benchmark runs.
"""

from __future__ import annotations

import numpy as np
import torch

NAMES = ("u", "v", "w")
FACES = ("xMinus", "xPlus", "yMinus", "yPlus", "zMinus", "zPlus")


def cell_widths(start: float, subdomains: list) -> np.ndarray:
    """Pressure-cell widths along one axis: each sub-domain's cells grow
    by a constant ratio (a uniform run where the ratio is 1)."""
    out, lo = [], float(start)
    for sub in subdomains:
        hi, n = float(sub["end"]), int(sub["cells"])
        ratio = float(sub.get("stretchRatio", 1.0))
        if abs(ratio - 1.0) <= 1e-12:
            out.append(np.full(n, (hi - lo) / n))
        else:
            h0 = (hi - lo) * (ratio - 1.0) / (ratio ** n - 1.0)
            out.append(h0 * ratio ** np.arange(n, dtype=np.float64))
        lo = hi
    return np.concatenate(out)


def roma(r: torch.Tensor, h: float) -> torch.Tensor:
    """Roma, Peskin and Berger (1999): the 3-point discrete delta."""
    x = torch.abs(r) / h
    inner = (1.0 + torch.sqrt(torch.clamp(1.0 - 3.0 * x * x, min=0.0))) / (
        3.0 * h)
    outer = (5.0 - 3.0 * x - torch.sqrt(
        torch.clamp(1.0 - 3.0 * (1.0 - x) ** 2, min=0.0))) / (6.0 * h)
    return torch.where(x > 1.5, torch.zeros_like(x),
                       torch.where(x > 0.5, outer, inner))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, to nearest)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _Line:
    """One velocity component's gridline along one direction: interior
    coordinates and widths, the ghost points' coordinates at both ends."""

    def __init__(self, dxp: np.ndarray, lo: float, same: bool):
        verts = lo + np.cumsum(dxp)
        if same:  # points on the interior cell faces, ghosts on the walls
            self.coord = np.concatenate(([lo], verts))
            self.dl = 0.5 * (dxp[:-1] + dxp[1:])
        else:  # cell centres, ghosts mirrored across the walls
            centres = lo + np.cumsum(dxp) - 0.5 * dxp
            self.coord = np.concatenate(([lo - 0.5 * dxp[0]], centres,
                                         [verts[-1] + 0.5 * dxp[-1]]))
            self.dl = dxp.copy()
        self.n = len(self.dl)
        self.dneg = self.coord[1:-1] - self.coord[:-2]
        self.dpos = self.coord[2:] - self.coord[1:-1]


class DecoupledIBPM:
    """The reference step on one case (``config``: a solver config dict
    with ``mesh``, ``flow`` and ``parameters``; ``body``: (points, dim)
    coordinates)."""

    def __init__(self, config: dict, body: np.ndarray, *, device,
                 precision: str = "float64"):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision {precision!r}: float64 or tf32")
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
        self.lines = [[_Line(self.dxp[d], self.lo[d], c == d)
                       for d in range(self.dim)] for c in range(self.dim)]
        self._faces(config["flow"]["boundaryConditions"])
        self._X = np.asarray(body, np.float64)[:, :self.dim]
        self.n_pts = len(self._X)
        self._built = False

    def _build(self) -> None:
        """The operators, the solves' transforms and the body's windows
        and blocks: at the first step (``initial_state`` needs none)."""
        if not self._built:
            self._operators()
            self._body(self._X)
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

    def _faces(self, bcs: list) -> None:
        """Each (component, face): its type, value, a0 and the distance
        from the ghost point to the point beside it."""
        table = {}
        for entry in bcs:
            for key, val in entry.items():
                if key != "location":
                    table[(key, entry["location"])] = (str(val[0]),
                                                       float(val[1]))
        self.face = {}
        for c in range(self.dim):
            for k in range(2 * self.dim):
                loc, d, hi = FACES[k], k // 2, k % 2 == 1
                kind, value = table[(NAMES[c], loc)]
                if kind not in ("DIRICHLET", "CONVECTIVE"):
                    raise ValueError(f"{NAMES[c]} at {loc}: the reference "
                                     "covers DIRICHLET and CONVECTIVE faces")
                coord = self.lines[c][d].coord
                dist = coord[-1] - coord[-2] if hi else coord[1] - coord[0]
                self.face[(c, k)] = {
                    "kind": kind, "value": value, "same": c == d,
                    "a0": 0.0 if c == d else -1.0,
                    "normal": 1.0 if hi else -1.0, "dist": float(dist),
                    "key": f"{NAMES[c]}_{loc}"}

    # ------------------------------------------------------------------
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
        # homogeneous Laplacian (the walls' a0 folded in) diagonalised
        cimp_nu = 0.5 * self.nu
        self.helm = []
        for c in range(dim):
            eig, vecs = [], []
            for d in range(dim):
                ln = self.lines[c][d]
                cn, cp = 1.0 / (ln.dneg * ln.dl), 1.0 / (ln.dpos * ln.dl)
                T = (np.diag(-(cn + cp)) + np.diag(cn[1:], -1)
                     + np.diag(cp[:-1], 1))
                T[0, 0] += cn[0] * self.face[(c, 2 * d)]["a0"]
                T[-1, -1] += cp[-1] * self.face[(c, 2 * d + 1)]["a0"]
                lam, V, Vi = self._diagonalise(T, ln.dl)
                eig.append(self._bcast(lam, d))
                vecs.append((V, Vi))
            denom = 1.0 / self.dt - cimp_nu * sum(eig)
            self.helm.append((vecs, 1.0 / denom))
        # the pressure solve: D dt G = dt (prod W) sum_c W_c^-1 K_c, K_c the
        # Neumann stiffness between cell centres
        eig, vecs = [], []
        for d in range(dim):
            dxp = self.dxp[d]
            g = 1.0 / (0.5 * (dxp[:-1] + dxp[1:]))
            K = np.diag(-np.concatenate((g, [0.0])) - np.concatenate(([0.0],
                                                                      g)))
            K += np.diag(g, 1) + np.diag(g, -1)
            lam, V, Vi = self._diagonalise(K / dxp[:, None], dxp)
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

    def _diagonalise(self, T: np.ndarray, w: np.ndarray) -> tuple:
        """T = W^-1 K with K symmetric and W = diag(w) > 0: T = V diag(lam)
        V^-1 with V = W^-1/2 Q, V^-1 = Q^T W^1/2 (Q from the symmetric
        W^-1/2 K W^-1/2), in float64."""
        s = np.sqrt(w)
        K = T * w[:, None]
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
    def _ghost(self, c, k, edge, bc):
        """A face's ghost layer from the layer beside it; ``bc`` None: the
        homogeneous relation (a1 = 0)."""
        face = self.face[(c, k)]
        g = face["a0"] * edge
        if bc is not None:
            g = g + bc[face["key"]]["a1"].unsqueeze(self.axis(k // 2))
        return g

    def _edge(self, c, k, x):
        ax = self.axis(k // 2)
        return x.narrow(ax, x.shape[ax] - 1 if k % 2 else 0, 1)

    def _pad_line(self, c, x, d, bc):
        """x with one ghost layer on both ends of direction d."""
        ax = self.axis(d)
        lo = self._ghost(c, 2 * d, self._edge(c, 2 * d, x), bc)
        hi = self._ghost(c, 2 * d + 1, self._edge(c, 2 * d + 1, x), bc)
        return torch.cat([lo, x, hi], dim=ax)

    def _pad_all(self, c, x, bc):
        """x with ghost layers in every direction (x first); a face's a1
        takes the edge values into the corners."""
        out, done = x, []
        for d in range(self.dim):
            ax = self.axis(d)
            layers = []
            for side in (0, 1):
                face = self.face[(c, 2 * d + side)]
                edge = out.narrow(ax, out.shape[ax] - 1 if side else 0, 1)
                a1 = bc[face["key"]]["a1"].unsqueeze(ax)
                for dp in done:
                    axp = self.axis(dp)
                    a1 = torch.cat([a1.narrow(axp, 0, 1), a1,
                                    a1.narrow(axp, a1.shape[axp] - 1, 1)],
                                   dim=axp)
                layers.append(face["a0"] * edge + a1)
            out = torch.cat([layers[0], out, layers[1]], dim=ax)
            done.append(d)
        return out

    def laplacian(self, q: dict, bc) -> dict:
        out = {}
        for c in range(self.dim):
            f, total = q[NAMES[c]], 0.0
            for d in range(self.dim):
                ax, n = self.axis(d), q[NAMES[c]].shape[self.axis(d)]
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
        out = 0.0
        for c in range(self.dim):
            ax = self.axis(c)
            ext = self._pad_line(c, q[NAMES[c]], c, bc)
            n = ext.shape[ax] - 1
            out = out + (ext.narrow(ax, 1, n) - ext.narrow(ax, 0, n)
                         ) * self.area[c]
        return out

    def gradient(self, p: torch.Tensor) -> dict:
        out = {}
        for c in range(self.dim):
            ax = self.axis(c)
            n = p.shape[ax] - 1
            out[NAMES[c]] = (p.narrow(ax, 1, n) - p.narrow(ax, 0, n)
                             ) * self.inv_dl[c][c]
        return out

    # ------------------------------------------------------------------
    def initial_bc(self, q: dict) -> dict:
        """The ghost state at the start: Dirichlet a1 from the value, a
        convective face's ghost equal to the point beside it."""
        bc = {}
        for (c, k), face in self.face.items():
            target = self._edge(c, k, q[NAMES[c]]).squeeze(self.axis(k // 2))
            if face["kind"] == "DIRICHLET":
                v = face["value"] if face["same"] else 2.0 * face["value"]
                a1 = torch.full_like(target, v)
                value = face["a0"] * target + a1
            else:
                value = target.clone()
                a1 = value.clone() if face["same"] else value + target
            bc[face["key"]] = {"a1": a1, "value": value}
        return bc

    def _convect_bc(self, bc: dict, q: dict) -> dict:
        """The convective outflow's a1 from the last ghost value, upwinded
        over the step."""
        new = dict(bc)
        for (c, k), face in self.face.items():
            if face["kind"] != "CONVECTIVE":
                continue
            st = bc[face["key"]]
            target = self._edge(c, k, q[NAMES[c]]).squeeze(self.axis(k // 2))
            adv = (face["normal"] * self.dt * face["value"]
                   * (st["value"] - target) / face["dist"])
            a1 = (st["value"] - adv if face["same"]
                  else st["value"] + target - 2.0 * adv)
            new[face["key"]] = {"a1": a1, "value": st["value"]}
        return new

    def _refresh_ghosts(self, bc: dict, q: dict) -> dict:
        new = {}
        for (c, k), face in self.face.items():
            st = bc[face["key"]]
            target = self._edge(c, k, q[NAMES[c]]).squeeze(self.axis(k // 2))
            new[face["key"]] = {"a1": st["a1"],
                                "value": face["a0"] * target + st["a1"]}
        return new

    # ------------------------------------------------------------------
    def _body(self, X: np.ndarray) -> None:
        """Each point's delta weights on the gridlines of each component
        (three lines beyond the kernel's support on each side), and the
        dense dt E H blocks."""
        h = []
        for d in range(self.dim):
            # the kernel's width: the u-grid cell at the first point
            verts = self.lo[d] + np.concatenate(([0.0],
                                                 np.cumsum(self.dxp[d])))
            cell = int(np.searchsorted(verts, X[0, d], side="right") - 1)
            h.append(float(self.lines[0][d].dl[cell]))
        self.win = []
        self.blocks = []
        for c in range(self.dim):
            per_dir, block = [], None
            for d in range(self.dim):
                ln = self.lines[c][d]
                coord = ln.coord[1:-1]
                near = np.searchsorted(coord, X[:, d])
                idx = near[:, None] + np.arange(-4, 4)[None, :]
                valid = (idx >= 0) & (idx < ln.n)
                idx = np.clip(idx, 0, ln.n - 1)
                r = torch.as_tensor(X[:, d:d + 1] - coord[idx])
                w = roma(r, h[d]).numpy() * valid
                per_dir.append((torch.as_tensor(idx, device=self.device),
                                self._t(w), self._t(w * ln.dl[idx])))
                rows = np.zeros((len(X), ln.n))
                np.add.at(rows, (np.arange(len(X))[:, None], idx), w)
                part = (rows * ln.dl[None, :]) @ rows.T
                block = part if block is None else block * part
            self.win.append(per_dir)
            M = self._t(self.dt * block)
            self.blocks.append(tf32(M) if self.tf32 else M)

    def _window_index(self, c: int) -> tuple:
        """The flat index into component c's array of every (point,
        window cell), and the matching tensor-product weights (delta,
        delta times cell volume)."""
        shape = self.shape(c)
        flat = None
        wd = wv = None
        for d in range(self.dim):
            idx, w, v = self.win[c][d]
            stride = int(np.prod(shape[self.axis(d) + 1:], dtype=np.int64))
            view = [idx.shape[0]] + [1] * self.dim
            view[1 + d] = idx.shape[1]
            term = (idx * stride).reshape(view)
            flat = term if flat is None else flat + term
            wd = w.reshape(view) if wd is None else wd * w.reshape(view)
            wv = v.reshape(view) if wv is None else wv * v.reshape(view)
        n = idx.shape[0]
        return flat.reshape(n, -1), wd.reshape(n, -1), wv.reshape(n, -1)

    def interpolate(self, q: dict) -> torch.Tensor:
        cols = []
        for c in range(self.dim):
            flat, _, wv = self._window_index(c)
            vals = q[NAMES[c]].reshape(-1)[flat]
            cols.append((vals * wv).sum(dim=1))
        return torch.stack(cols, dim=1)

    def spread(self, f: torch.Tensor) -> dict:
        out = {}
        for c in range(self.dim):
            flat, wd, _ = self._window_index(c)
            grid = torch.zeros(int(np.prod(self.shape(c))), dtype=self.dtype,
                               device=self.device)
            grid.index_add_(0, flat.reshape(-1),
                            (wd * f[:, c:c + 1]).reshape(-1))
            out[NAMES[c]] = grid.reshape(self.shape(c))
        return out

    def _solve_forces(self, rhs: torch.Tensor) -> torch.Tensor:
        b = tf32(rhs) if self.tf32 else rhs
        return torch.stack([torch.linalg.solve(self.blocks[c], b[:, c])
                            for c in range(self.dim)], dim=1)

    # ------------------------------------------------------------------
    def step(self, st: dict) -> dict:
        """One time step of the state dict (module docstring)."""
        self._build()
        dt, nu, names = self.dt, self.nu, NAMES[:self.dim]
        q, p, f, bc = st["q"], st["p"], st["f"], st["bc"]
        gp = self.gradient(p)
        nq = self.convection(q, bc)
        conv = ({k: -nq[k] for k in names}, st["conv"][0])
        lq = self.laplacian(q, bc)
        bc = self._convect_bc(bc, q)
        zero = {k: torch.zeros_like(q[k]) for k in names}
        corr = self.laplacian(zero, bc)
        hf = self.spread(f)
        rhs1 = {k: q[k] / dt - gp[k] + 1.5 * conv[0][k] - 0.5 * conv[1][k]
                + 0.5 * nu * lq[k] + 0.5 * nu * corr[k] + hf[k]
                for k in names}
        ustar = {names[c]: self._fast_solve(self.helm[c][0], self.helm[c][1],
                                            rhs1[names[c]])
                 for c in range(self.dim)}
        df = self._solve_forces(-self.interpolate(ustar))
        hdf = self.spread(df)
        ustar = {k: ustar[k] + dt * hdf[k] for k in names}
        rhs2 = self.divergence(ustar, bc)
        rhs2 = rhs2 - rhs2.mean()
        vecs, inv, dt_vol = self.poisson
        dP = self._fast_solve(vecs, inv, rhs2 / dt_vol)
        dP = dP - dP.mean()
        gdp = self.gradient(dP)
        qn = {k: ustar[k] - dt * gdp[k] for k in names}
        return {"q": qn, "p": p + dP, "f": f + df, "conv": conv,
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
                "f": t(tree["f"]),
                "conv": tuple({k: t(h[k]) for k in names}
                              for h in tree["conv"][:2]),
                "bc": {k: {"a1": t(v["a1"]), "value": t(v["value"])}
                       for k, v in tree["bc"].items()}}

    def initial_state(self, q0: dict) -> dict:
        """The whole state at step 0 from velocity fields ``q0`` (numpy
        float64): p, f, the histories and the warm starts zero, the ghost
        state from q0.  Numpy leaves; the keys of a decoupled-IBPM
        solver's state."""
        names = NAMES[:self.dim]
        q = {k: torch.as_tensor(q0[k], dtype=torch.float64) for k in names}
        bc = self.initial_bc(q)
        zeros = {k: np.zeros(self.shape(c)) for c, k in enumerate(names)}
        p0 = np.zeros(self.shape(self.dim))
        f0 = np.zeros((self.n_pts, self.dim))
        return {"q": {k: np.asarray(q0[k], np.float64) for k in names},
                "p": p0, "dP": p0.copy(), "f": f0, "df": f0.copy(),
                "conv": (dict(zeros), dict(zeros)), "diff": (dict(zeros),),
                "bc": {k: {"a1": v["a1"].numpy(), "value": v["value"].numpy()}
                       for k, v in bc.items()}}

