"""Native host-runtime bindings (C++ hostcore via ctypes).

The TPU compute path is JAX/XLA/Pallas; hostcore covers the host-side
runtime the reference implements in C++ — Lagrangian body file
ingestion/emission, stretched-grid generation, and owning-cell searches
(reference: src/io/io.cpp:23, include/petibm/misc.h:148,
src/body/singlebodypoints.cpp:95).  The library is compiled on demand with
g++ into the user cache; every entry point has a NumPy fallback so the
framework works (slower) without a toolchain.

Set ``PETIBM_TPU_NO_NATIVE=1`` to force the Python fallbacks.

Copy of ``petibm_tpu/native/__init__.py``, with ``hostcore.cpp`` a copy
of ``petibm_tpu/native/hostcore.cpp`` (both held equal to the originals
by tests/test_torch_host.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import warnings

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "hostcore.cpp")
_LIB = None
_TRIED = False


def _cache_dir() -> str:
    base = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    return os.path.join(base, "petibm_tpu_native")


def _build() -> str | None:
    """Compile hostcore.cpp into a content-addressed .so; return its path."""
    with open(_SRC, "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:16]
    out_dir = _cache_dir()
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"hostcore-{tag}.so")
    if os.path.isfile(so):
        return so
    tmp = so + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as exc:
        warnings.warn(f"petibm_tpu native hostcore build failed ({exc}); "
                      "using Python fallbacks")
        return None
    os.replace(tmp, so)  # atomic vs concurrent builders
    return so


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("PETIBM_TPU_NO_NATIVE"):
        return None
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError as exc:  # pragma: no cover - bad cached artifact
        warnings.warn(f"petibm_tpu native hostcore load failed ({exc})")
        return None
    c_dp = ctypes.POINTER(ctypes.c_double)
    c_ip = ctypes.POINTER(ctypes.c_int64)
    lib.ptn_stretch_grid.argtypes = [ctypes.c_double, ctypes.c_double,
                                     ctypes.c_int64, ctypes.c_double, c_dp]
    lib.ptn_probe_points.argtypes = [ctypes.c_char_p, c_ip,
                                     ctypes.POINTER(ctypes.c_int32)]
    lib.ptn_read_points.argtypes = [ctypes.c_char_p, c_dp, ctypes.c_int64,
                                    ctypes.c_int32]
    lib.ptn_write_points.argtypes = [ctypes.c_char_p, c_dp, ctypes.c_int64,
                                     ctypes.c_int32, ctypes.c_int32]
    lib.ptn_search_cells.argtypes = [c_dp, ctypes.c_int64, c_dp,
                                     ctypes.c_int64, c_ip]
    for fn in (lib.ptn_stretch_grid, lib.ptn_probe_points, lib.ptn_read_points,
               lib.ptn_write_points, lib.ptn_search_cells):
        fn.restype = ctypes.c_int
    lib.ptn_abi_version.restype = ctypes.c_int
    if lib.ptn_abi_version() != 1:  # pragma: no cover
        return None
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def stretch_grid(begin: float, end: float, n: int, ratio: float) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    out = np.empty(int(n), dtype=np.float64)
    if lib.ptn_stretch_grid(float(begin), float(end), int(n), float(ratio),
                            _dptr(out)) != 0:
        return None
    return out


def read_lagrangian_points(path: str) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    n = ctypes.c_int64()
    dim = ctypes.c_int32()
    if lib.ptn_probe_points(path.encode(), ctypes.byref(n),
                            ctypes.byref(dim)) != 0:
        return None
    if n.value < 0 or dim.value not in (2, 3):
        return None
    out = np.empty((n.value, dim.value), dtype=np.float64)
    if lib.ptn_read_points(path.encode(), _dptr(out), n.value, dim.value) != 0:
        raise ValueError(
            f"{path}: expected {n.value} points of dim {dim.value}; "
            "file is malformed or truncated")
    return out


def write_lagrangian_points(path: str, coords: np.ndarray,
                            with_count: bool = False) -> bool:
    lib = _load()
    if lib is None:
        return False
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    return lib.ptn_write_points(path.encode(), _dptr(coords), coords.shape[0],
                                coords.shape[1], int(with_count)) == 0


def search_cells(grid: np.ndarray, x: np.ndarray) -> np.ndarray | None:
    """Index i per query with grid[i] <= x < grid[i+1] (upper_bound - 1)."""
    lib = _load()
    if lib is None:
        return None
    grid = np.ascontiguousarray(grid, dtype=np.float64)
    x = np.ascontiguousarray(x, dtype=np.float64)
    out = np.empty(x.shape[0], dtype=np.int64)
    if lib.ptn_search_cells(_dptr(grid), grid.shape[0], _dptr(x), x.shape[0],
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))) != 0:
        return None
    return out


if __name__ == "__main__":  # quick self-check
    print("hostcore available:", available(), file=sys.stderr)
