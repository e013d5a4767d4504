"""Interpolation E and spreading H of the factor delta engine as two
hand-written CUDA kernels (``csrc/delta_ops.cu``) over each point's window
of K gridlines a direction.

The windows are ``DeltaOp.windows``'s K forms, per component c:
``idx`` (dim, N, K) int32, the gridlines of each point's window per
direction (x first), ``wv`` its volume weights (E) and ``wd`` its delta
weights (H), ``lo`` / ``hi`` the window box per direction.  No kernel of
the JAX package's corresponds: it contracts dense (N, n_d) factor rows
over whole grid lines.

- ``interpolate`` (E): (N, dim), out[p, c] = sum over the K^dim window
  cells, in (kz, ky, kx) order from 0, of u_c * ((wz * wy) * wx); one
  launch for all components.
- ``spread`` (H): adds [scale *] H f into the component arrays it is
  given, in place, over each component's window box; one launch for all
  components.  A cell sums, in point order, ((f * Fz) * Fy) * Fx, each Fd
  the sum, in window order, of the point's weights on the cell's
  gridline.  No atomics: its bits repeat from run to run.

Each wrapper launches its kernel on CUDA tensors (one more in its
``launches`` counter, the C entry's error raised) on the current stream,
with no synchronisation and no allocation but E's output, so a CUDA graph
captures it; on CPU tensors it calls its plain twin (``*_ref``), which
sums in the kernel's order, each product and sum rounded on its own: the
kernel equals it bit for bit.  It never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from .._kernels import c_function, check_dtype, count_launch, ptr, stream

#: the window half-widths the kernels have instances of (K = 5, 7)
KERNEL_K = (5, 7)


class _Component(ctypes.Structure):
    """``DeltaComponent`` of ``csrc/delta_ops.cu``."""
    _fields_ = [("field", ctypes.c_void_p), ("idx", ctypes.c_void_p),
                ("w", ctypes.c_void_p), ("stride", ctypes.c_longlong * 3),
                ("lo", ctypes.c_int * 3), ("hi", ctypes.c_int * 3)]


class _Args(ctypes.Structure):
    """``DeltaArgs`` of ``csrc/delta_ops.cu``."""
    _fields_ = [("points", ctypes.c_void_p), ("scale", ctypes.c_double),
                ("n_pts", ctypes.c_int), ("dim", ctypes.c_int),
                ("k", ctypes.c_int), ("scaled", ctypes.c_int),
                ("comp", _Component * 3)]


# ----------------------------------------------------------------------
# the plain twins

def interpolate_ref(fields: list, win: dict) -> torch.Tensor:
    """E: (N, dim), each column the sum over the window cells, in (kz, ky,
    kx) order from 0, of u_c * ((wz * wy) * wx) (2D: u_c * (wy * wx))."""
    dim = len(fields)
    cols = []
    for c, u in enumerate(fields):
        idx, w = win[c]["idx"].long(), win[c]["wv"]
        if dim == 3:
            vals = u[idx[2][:, :, None, None], idx[1][:, None, :, None],
                     idx[0][:, None, None, :]]
            wgt = ((w[2][:, :, None] * w[1][:, None, :])[..., None]
                   * w[0][:, None, None, :])
        else:
            vals = u[idx[1][:, :, None], idx[0][:, None, :]]
            wgt = w[1][:, :, None] * w[0][:, None, :]
        terms = (vals * wgt).reshape(vals.shape[0], -1)
        acc = torch.zeros(terms.shape[0], dtype=u.dtype, device=u.device)
        for j in range(terms.shape[1]):
            acc = acc + terms[:, j]
        cols.append(acc)
    return torch.stack(cols, dim=1)


def _factors(idx: torch.Tensor, w: torch.Tensor) -> tuple:
    """Per window slot: the factor value of its gridline (the weights of
    the slots on it, summed in slot order from 0, as the kernel's
    ``factor``) and whether it is the first slot on its gridline."""
    K = idx.shape[-1]
    F = torch.zeros_like(w)
    for k in range(K):
        F = F + torch.where(idx[..., k:k + 1] == idx, w[..., k:k + 1], 0.0)
    earlier = torch.ones(K, K, dtype=torch.bool, device=idx.device).tril(-1)
    first = ~((idx[..., :, None] == idx[..., None, :]) & earlier).any(-1)
    return F, first


def _box(w: dict, dim: int) -> tuple:
    """Component's window box as (z, y, x) slices of its array."""
    return tuple(slice(w["lo"][d], w["hi"][d]) for d in reversed(range(dim)))


def spread_ref(f: torch.Tensor, win: dict, fields: list,
               scale: float | None = None) -> None:
    """H: adds [scale *] H f into ``fields`` in place over each window box;
    a cell sums its points' products ((f * Fz) * Fy) * Fx (2D: (f * Fy)
    * Fx) in point order from 0.  The points of a cell are ranked by a
    stable sort of the cells, and rank r's products are added to their
    distinct cells at once."""
    dim = len(fields)
    for c, g in enumerate(fields):
        idx = win[c]["idx"].long()
        F, first = _factors(idx, win[c]["wd"])
        fc = f[:, c]
        n = g.shape
        if dim == 3:
            vals = (((fc[:, None] * F[2])[:, :, None] * F[1][:, None, :])
                    [..., None] * F[0][:, None, None, :])
            lin = ((idx[2][:, :, None, None] * n[1] + idx[1][:, None, :, None])
                   * n[2] + idx[0][:, None, None, :])
            keep = (first[2][:, :, None, None] & first[1][:, None, :, None]
                    & first[0][:, None, None, :])
        else:
            vals = (fc[:, None] * F[1])[:, :, None] * F[0][:, None, :]
            lin = idx[1][:, :, None] * n[1] + idx[0][:, None, :]
            keep = first[1][:, :, None] & first[0][:, None, :]
        # one entry a (point, cell), in point order
        lin, vals = lin[keep], vals[keep]
        lin, order = torch.sort(lin, stable=True)
        vals = vals[order]
        pos = torch.arange(lin.numel(), device=lin.device)
        new = torch.ones_like(lin, dtype=torch.bool)
        new[1:] = lin[1:] != lin[:-1]
        rank = pos - torch.cummax(torch.where(new, pos, 0), 0).values
        acc = torch.zeros(g.numel(), dtype=g.dtype, device=g.device)
        for r in range(int(rank.max()) + 1 if rank.numel() else 0):
            at = rank == r
            cells = lin[at]
            acc[cells] = acc[cells] + vals[at]
        box = _box(win[c], dim)
        part = acc.view(n)[box]
        g[box].add_(part if scale is None else scale * part)


# ----------------------------------------------------------------------
# the kernels

def _check(name: str, fields: list, points: torch.Tensor, win: dict) -> int:
    """Raise on what the kernel does not take; returns K."""
    dim = len(fields)
    if dim not in (2, 3):
        raise ValueError(f"{name} takes 2 or 3 components, got {dim}")
    like = fields[0]
    check_dtype(name, like)
    K = win[0]["idx"].shape[-1]
    if K not in KERNEL_K:
        raise ValueError(f"{name} has instances for K in {KERNEL_K}, got {K}")
    n_pts = points.shape[0]
    if points.shape != (n_pts, dim) or not points.is_contiguous():
        raise ValueError(f"{name} takes contiguous (N, {dim}) points")
    for t in [*fields, points]:
        if t.device != like.device or t.dtype != like.dtype:
            raise ValueError(f"{name}: fields and points must share one "
                             "device and dtype")
        if t.device.type != "cuda":
            raise ValueError(f"{name} runs on cuda or cpu tensors, "
                             f"got {t.device}")
    for c in range(dim):
        idx, w = win[c]["idx"], win[c]["wv"]
        for t, dtype in ((idx, torch.int32), (w, like.dtype),
                         (win[c]["wd"], like.dtype)):
            if (t.shape != (dim, n_pts, K) or t.dtype != dtype
                    or t.device != like.device or not t.is_contiguous()):
                raise ValueError(f"{name}: the windows must be contiguous "
                                 f"({dim}, N, K) tensors on the fields' "
                                 "device (idx int32)")
    return K


def _args(fields: list, points, win: dict, key: str, K: int,
          scale) -> _Args:
    dim = len(fields)
    a = _Args(points=ptr(points), scale=0.0 if scale is None else scale,
              n_pts=points.shape[0], dim=dim, k=K,
              scaled=int(scale is not None))
    for c, g in enumerate(fields):
        box = [(win[c]["lo"][d], win[c]["hi"][d]) if d < dim else (0, 1)
               for d in range(3)]
        strides = list(reversed(g.stride())) + [0] * (3 - dim)
        a.comp[c] = _Component(
            field=ptr(g), idx=ptr(win[c]["idx"]), w=ptr(win[c][key]),
            stride=(ctypes.c_longlong * 3)(*strides),
            lo=(ctypes.c_int * 3)(*(b[0] for b in box)),
            hi=(ctypes.c_int * 3)(*(b[1] for b in box)))
    return a


def _launch(entry: str, a: _Args, like: torch.Tensor) -> None:
    fn = c_function("delta_ops", entry, like.dtype,
                    [ctypes.c_void_p, ctypes.c_void_p])
    err = fn(ctypes.byref(a), stream(like.device))
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def interpolate(fields: list, win: dict) -> torch.Tensor:
    """E u onto the points: (N, dim) from the component arrays ``fields``
    (x first) and the windows' ``idx`` / ``wv``.  CUDA arrays launch
    ``delta_interpolate`` (one more in ``interpolate.launches``); CPU
    arrays run ``interpolate_ref``."""
    if fields[0].device.type == "cpu":
        return interpolate_ref(fields, win)
    n_pts = win[0]["idx"].shape[1]
    out = torch.empty((n_pts, len(fields)), dtype=fields[0].dtype,
                      device=fields[0].device)
    K = _check("delta_interpolate", fields, out, win)
    _launch("delta_interpolate", _args(fields, out, win, "wv", K, None),
            fields[0])
    count_launch(interpolate)
    return out


interpolate.launches = 0


def spread(f: torch.Tensor, win: dict, fields: list,
           scale: float | None = None) -> None:
    """Adds [scale *] H f into the component arrays ``fields`` (x first)
    in place over each window box, from the (N, dim) forces ``f`` and the
    windows' ``idx`` / ``wd``.  CUDA arrays launch ``delta_spread`` (one
    more in ``spread.launches``); CPU arrays run ``spread_ref``."""
    if fields[0].device.type == "cpu":
        spread_ref(f, win, fields, scale)
        return
    K = _check("delta_spread", fields, f, win)
    _launch("delta_spread", _args(fields, f, win, "wd", K, scale), fields[0])
    count_launch(spread)


spread.launches = 0
