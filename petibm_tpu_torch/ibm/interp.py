"""Interpolation (E) and spreading (H) through regularized delta windows.

Counterpart of ``petibm_tpu/ibm/interp.py`` (the factor engine,
interp.py:38-161, the windowed engine :164-312, ``dense_ebnh_blocks`` :314
and ``make_delta_op`` :337; reference: createdelta.cpp:28-208,
decoupledibpm.cpp:149-216).  The tensor-product delta is kept separated
as per-direction banded factor matrices S_d of shape (nPts, n_d), each row
holding one Lagrangian point's 1D kernel weights on its ±w gridline
window.  Then

  interpolation (2D):  E u = sum_x ( (S_y^vol @ u) * S_x^vol )
  spreading (2D):      H f = (S_y^delta * f)^T @ S_x^delta

as dense matmuls.  Above WINDOWED_THRESHOLD points ``auto`` picks
``WindowedDeltaOp``, which keeps only the (N, K) window weights and
expands them to factor rows chunk by chunk inside each apply.

Decomposed over a process group (``set_mesh``), each rank keeps the
global windows and works on its block alone: the factor engine
contracts its block's columns of the (N, n_d) factor rows
(``local_windows``), the windowed engine the part of each window box
inside its block (``WindowedDeltaOp._span``).  In both, E sums the
ranks' partials (one all-reduce) and H writes the rank's block with no
communication; the diagonal reductions (diag(E B1 H)) read the global
windows, as undecomposed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh import StaggeredMesh
from ..types import Field
from .delta import KERNELS

VEL_NAMES = ("u", "v", "w")


class DeltaOp:
    """The factor-matrix delta engine: windows, E and H on tensors."""

    #: True for the windowed engine, whose windows hold no (N, n_d) factor
    #: rows: the consumers of dense E B_N H blocks check it
    windowed = False
    #: the rank's ``Partition`` of a decomposed run, else None
    part = None

    def __init__(self, mesh: StaggeredMesh, kernel: str = "ROMA_ET_AL_1999",
                 *, dtype: torch.dtype, device):
        self.mesh = mesh
        self.dim = mesh.dim
        self.kernel, self.half = KERNELS[kernel]
        self.dtype = dtype
        self.device = device

        def t(arr):
            return torch.as_tensor(np.asarray(arr, np.float64), dtype=dtype,
                                   device=device)

        self.vertex = [t(mesh.coord(Field.VERTEX, d)) for d in range(self.dim)]
        self.L = [float(mesh.max[d] - mesh.min[d]) for d in range(self.dim)]
        self.periodic = mesh.periodic
        self.coord = {c: [t(mesh.coord(Field(c), d)) for d in range(self.dim)]
                      for c in range(self.dim)}
        self.dl = {c: [t(mesh.dl(Field(c), d)) for d in range(self.dim)]
                   for c in range(self.dim)}
        self.n = {c: [mesh.n(Field(c), d) for d in range(self.dim)]
                  for c in range(self.dim)}
        # u-grid dl per direction for the kernel widths
        # (reference: createdelta.cpp:69-77)
        self.width_dl = [t(mesh.dl(Field.U, d)) for d in range(self.dim)]

    # ------------------------------------------------------------------
    def cell_index(self, X: torch.Tensor) -> torch.Tensor:
        """Owning pressure-cell index per point per direction
        (reference: singlebodypoints.cpp:95-120)."""
        cols = [torch.searchsorted(self.vertex[d], X[:, d].contiguous(),
                                   right=True) - 1
                for d in range(self.dim)]
        return torch.stack(cols, dim=1)

    def _window_weights(self, X) -> dict:
        """The K window gridlines and 1D kernel weights of every point:
        {c: [per-dir (idx, w)]}, each (N, K); walls clamp the index and
        zero the weight, periodic directions wrap (JAX interp.py:92-114)."""
        X = torch.as_tensor(X, dtype=self.dtype, device=self.device)
        ijk = self.cell_index(X)
        offsets = torch.arange(-self.half, self.half + 1, device=self.device)
        # kernel widths from the u-grid cell of the first body point
        # (reference: createdelta.cpp:69-77, assumes a uniform region);
        # index_select keeps the index on the device: a moving body's
        # windows, recomputed every step, read nothing on the host
        widths = [self.width_dl[d].index_select(0, ijk[:1, d])
                  for d in range(self.dim)]

        out = {}
        for c in range(self.dim):
            out[c] = []
            for d in range(self.dim):
                n = self.n[c][d]
                s = ijk[:, d:d + 1] + offsets[None, :]  # (N, K)
                if self.periodic[d]:
                    idx = torch.remainder(s, n)
                    shift = (torch.div(s, n, rounding_mode="floor")
                             .to(self.dtype) * self.L[d])
                    x = self.coord[c][d][idx] + shift
                    valid = torch.ones_like(s, dtype=torch.bool)
                else:
                    valid = (s >= 0) & (s < n)
                    idx = torch.clamp(s, 0, n - 1)
                    x = self.coord[c][d][idx]
                w = self.kernel(X[:, d:d + 1] - x, widths[d])
                out[c].append((idx, torch.where(valid, w,
                                                torch.zeros_like(w))))
        return out

    def windows(self, X) -> dict:
        """Banded factor matrices for all components:
        {c: {"sd": [per-dir (N, n_d)], "sv": [per-dir (N, n_d)]}}; sd holds
        the 1D delta weights, sv additionally the component cell widths
        (prod over directions of sv = delta * cell volume, the E scaling)."""
        out = {}
        for c, dirs in self._window_weights(X).items():
            sd_d, sv_d = [], []
            for d, (idx, w) in enumerate(dirs):
                # the K window weights into banded (N, n) rows
                sd = torch.zeros((idx.shape[0], self.n[c][d]),
                                 dtype=self.dtype,
                                 device=self.device).scatter_add_(1, idx, w)
                sd_d.append(sd)
                sv_d.append(sd * self.dl[c][d][None, :])
            out[c] = {"sd": sd_d, "sv": sv_d}
        return out

    def set_mesh(self, part) -> None:
        """Interpolate and spread on the rank's blocks of a decomposed
        run: ``windows`` stays global, ``local_windows`` cuts it."""
        self.part = part

    def local_windows(self, win: dict) -> dict:
        """The factor rows' columns of the rank's block (all of them when
        undecomposed)."""
        if self.part is None:
            return win
        out = {}
        for c, w in win.items():
            cols = [slice(*self.part.range(Field(c), d))
                    for d in range(self.dim)]
            out[c] = {k: [m[:, cols[d]] for d, m in enumerate(v)]
                      for k, v in w.items()}
        return out

    # ------------------------------------------------------------------
    def interpolate(self, q: dict, win: dict) -> torch.Tensor:
        """E u: volume-weighted interpolation onto the Lagrangian points;
        returns (N, dim), summed over the ranks of a decomposed run."""
        cols = []
        for c in range(self.dim):
            w = win[c]
            arr = q[VEL_NAMES[c]]
            if self.dim == 2:
                t = torch.matmul(w["sv"][1], arr)
            else:
                t = torch.einsum("pz,zyx->pyx", w["sv"][2], arr)
                t = torch.einsum("py,pyx->px", w["sv"][1], t)
            cols.append(torch.sum(t * w["sv"][0], dim=1))
        out = torch.stack(cols, dim=1)
        return out if self.part is None else self.part.allreduce_sum(out)

    def spread(self, f: torch.Tensor, win: dict) -> dict:
        """H f = Delta^T f: spread the (N, dim) Lagrangian forces onto the
        grids; returns a velocity-space dict."""
        out = {}
        for c in range(self.dim):
            w = win[c]
            fc = f[:, c]
            if self.dim == 2:
                out[VEL_NAMES[c]] = torch.matmul(
                    (w["sd"][1] * fc[:, None]).T, w["sd"][0])
            else:
                t = torch.einsum("pz,py->pzy", w["sd"][2] * fc[:, None],
                                 w["sd"][1])
                out[VEL_NAMES[c]] = torch.einsum("pzy,px->zyx", t, w["sd"][0])
        return out


class WindowedDeltaOp(DeltaOp):
    """The large-body delta engine (JAX interp.py:164-312): the windows
    keep the K weights of each point per direction, ``idx``/``sd``/``sv``
    of shape (N, K), so their memory and build are O(N K).  E and H keep
    the factor engine's separable matmul algebra: each chunk of B points
    has its (B, K) rows expanded to dense factor rows (``_expand``) and
    contracted with ``torch.einsum``/``matmul``, so no atomics enter the
    spread and its bits repeat from run to run.

    Two choices differ from the JAX engine and change only which exact
    zeros enter a sum:
    - the factor rows span only the window box, the gridlines
      ``lo[d]:hi[d]`` the body's windows touch (read once per
      ``windows`` call), not the whole grid line: every product outside
      the box is a zero;
    - the chunk budget is the card's (``_chunk_budget``), not the TPU's
      128 MB; chunking changes only the order in which H sums its chunks.
    The banded reductions the solvers share (diag(E B1 H) from
    sum(sd * sv, axis=1)) equal the factor engine's: its (N, n_d) rows
    hold the same K nonzeros.
    """

    windowed = True

    #: bytes of a chunk's largest intermediate, (B, plane of the window
    #: box); the JAX engine's is 128 MB
    _chunk_budget = 512 * 1024 * 1024
    #: the largest chunk (the JAX engine caps it at 8192)
    _max_chunk = 1 << 16

    def set_mesh(self, part) -> None:
        """Interpolate and spread on the rank's blocks of a decomposed
        run: the windows stay global (``local_windows`` passes them on)
        and E and H take the part of each window box in the block."""
        self.part = part

    def local_windows(self, win: dict) -> dict:
        return win

    def _span(self, w: dict, c: int) -> tuple:
        """(lo, hi) per direction: component ``c``'s window box, cut to
        the rank's block on a decomposed run (global indices; hi <= lo
        where they do not meet)."""
        if self.part is None:
            return w["lo"], w["hi"]
        rng = [self.part.range(Field(c), d) for d in range(self.dim)]
        return ([max(w["lo"][d], rng[d][0]) for d in range(self.dim)],
                [min(w["hi"][d], rng[d][1]) for d in range(self.dim)])

    def _local(self, c: int, lo: list, hi: list) -> tuple:
        """The span as (z, y, x) slices of the rank's array."""
        org = ([0] * self.dim if self.part is None
               else [self.part.range(Field(c), d)[0]
                     for d in range(self.dim)])
        return tuple(slice(lo[d] - org[d], hi[d] - org[d])
                     for d in reversed(range(self.dim)))

    def windows(self, X) -> dict:
        """{c: {"idx", "sd", "sv": [per-dir (N, K)], "lo", "hi": [per-dir
        int]}}: the JAX engine's keys, and the window box of each
        component on the host (one read)."""
        weights = self._window_weights(X)
        ends = torch.stack([torch.stack([idx.min(), idx.max()])
                            for dirs in weights.values()
                            for idx, _ in dirs]).tolist()
        out, k = {}, 0
        for c, dirs in weights.items():
            ent = {"idx": [], "sd": [], "sv": [], "lo": [], "hi": []}
            for d, (idx, w) in enumerate(dirs):
                ent["idx"].append(idx)
                ent["sd"].append(w)
                ent["sv"].append(w * self.dl[c][d][idx])
                ent["lo"].append(int(ends[k][0]))
                ent["hi"].append(int(ends[k][1]) + 1)
                k += 1
            out[c] = ent
        return out

    def _chunk_size(self, w: dict, span: tuple | None = None) -> int:
        """Points per chunk: the budget over the bytes of one point's
        (plane) row, the plane being the span's extents but the
        last-contracted one, rounded down to a power of two in [8,
        _max_chunk] (JAX ``_chunk_size``)."""
        lo, hi = (w["lo"], w["hi"]) if span is None else span
        plane = 1
        for d in range(self.dim - 1):
            plane *= hi[d] - lo[d]
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        b = self._chunk_budget // max(1, plane * itemsize)
        b = min(self._max_chunk, 1 << int(b).bit_length() >> 1) if b >= 1 else 1
        return max(8, b)

    def _expand(self, span: tuple, d: int, idx, wt) -> torch.Tensor:
        """(B, K) banded rows -> (B, hi - lo) dense factor rows over the
        span, by one-hot comparison (no scatter)."""
        grid = torch.arange(span[0][d], span[1][d], device=idx.device)
        onehot = (idx[:, :, None] == grid[None, None, :]).to(self.dtype)
        return torch.einsum("pk,pkn->pn", wt, onehot)

    def _chunks(self, w: dict, key: str, span: tuple):
        """(first, last, expanded factor rows per direction) per chunk."""
        N = w["idx"][0].shape[0]
        B = self._chunk_size(w, span)
        for a in range(0, N, B):
            b = min(N, a + B)
            yield a, b, [self._expand(span, d, w["idx"][d][a:b],
                                      w[key][d][a:b])
                         for d in range(self.dim)]

    def interpolate(self, q: dict, win: dict) -> torch.Tensor:
        """E u chunk by chunk on the window box (its part in the rank's
        block): the factor engine's algebra with (B, box) factor rows;
        returns (N, dim), summed over the ranks of a decomposed run."""
        cols = []
        for c in range(self.dim):
            w = win[c]
            lo, hi = span = self._span(w, c)
            if any(b <= a for a, b in zip(lo, hi)):
                cols.append(torch.zeros(w["idx"][0].shape[0],
                                        dtype=self.dtype,
                                        device=self.device))
                continue
            arr = q[VEL_NAMES[c]][self._local(c, lo, hi)]
            if self.dim == 3:
                # (bz, by * bx) once for every chunk's matmul
                arr = arr.reshape(arr.shape[0], -1)
            parts = []
            for _, _, s in self._chunks(w, "sv", span):
                if self.dim == 2:
                    t = torch.matmul(s[1], arr)
                else:
                    t = torch.matmul(s[2], arr).reshape(
                        s[2].shape[0], s[1].shape[1], s[0].shape[1])
                    t = torch.einsum("py,pyx->px", s[1], t)
                parts.append(torch.sum(t * s[0], dim=1))
            cols.append(torch.cat(parts))
        out = torch.stack(cols, dim=1)
        return out if self.part is None else self.part.allreduce_sum(out)

    def spread(self, f: torch.Tensor, win: dict) -> dict:
        """H f chunk by chunk on the window box (its part in the rank's
        block), the chunks summed in order, then placed in the
        component's zero grid (the rank's block)."""
        out = {}
        for c in range(self.dim):
            w = win[c]
            shape = (tuple(self.n[c][d] for d in reversed(range(self.dim)))
                     if self.part is None
                     else self.part.local_shape(Field(c)))
            full = torch.zeros(shape, dtype=self.dtype, device=self.device)
            out[VEL_NAMES[c]] = full
            lo, hi = span = self._span(w, c)
            if any(b <= a for a, b in zip(lo, hi)):
                continue
            acc = None
            for a, b, s in self._chunks(w, "sd", span):
                fc = f[a:b, c]
                if self.dim == 2:
                    g = torch.matmul((s[1] * fc[:, None]).T, s[0])
                else:
                    t = torch.einsum("pz,py->pzy", s[2] * fc[:, None], s[1])
                    g = torch.einsum("pzy,px->zyx", t, s[0])
                acc = g if acc is None else acc + g
            full[self._local(c, lo, hi)] = acc
        return out


def dense_ebnh_blocks(win: dict, dim: int, dt: float) -> list:
    """Per-component dense (N, N) blocks of E B1 H = dt * E H for factor
    windows: the product over directions of S_vol,d @ S_delta,d^T
    (reference assembles it sparsely, decoupledibpm.cpp:171-216)."""
    mats = []
    for c in range(dim):
        m = None
        for d in range(dim):
            a = torch.matmul(win[c]["sv"][d], win[c]["sd"][d].T)
            m = a if m is None else m * a
        mats.append(dt * m)
    return mats


#: factor-matrix engine up to this many Lagrangian points, windowed above
#: (JAX interp.py:334: the (N, n_d) factors and their build dominate)
WINDOWED_THRESHOLD = 16384


def make_delta_op(mesh: StaggeredMesh, kernel: str = "ROMA_ET_AL_1999", *,
                  dtype: torch.dtype, device, n_pts: int | None = None,
                  engine: str = "auto") -> DeltaOp:
    """Pick the delta engine as the JAX package does: ``auto`` takes the
    factor engine up to WINDOWED_THRESHOLD points and the windowed engine
    above; ``factor`` / ``windowed`` force one."""
    if engine == "auto":
        engine = ("windowed" if n_pts is not None
                  and n_pts > WINDOWED_THRESHOLD else "factor")
    if engine == "windowed":
        return WindowedDeltaOp(mesh, kernel, dtype=dtype, device=device)
    if engine == "factor":
        return DeltaOp(mesh, kernel, dtype=dtype, device=device)
    raise ValueError(f"unknown delta engine {engine!r} "
                     "(want auto|factor|windowed)")
