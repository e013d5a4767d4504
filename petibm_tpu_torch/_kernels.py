"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` into a content-hashed shared library under
``build/torch_kernels/`` (at the repository root, git-ignored) at first
use, then loaded with ``ctypes``.  A source without PyTorch headers
builds in seconds, so every fresh checkout builds from its own sources.
Nothing is imported or compiled when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(name: str) -> tuple[Path, float]:
    """Compile ``csrc/<name>.cu`` unless a library built from the same
    source and flags exists; returns the library path and the build
    seconds (0.0 when it was already built)."""
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{name}-{digest}.so"
    if so.is_file():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    os.replace(tmp, so)  # atomic against a build running alongside
    return so, time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path, _ = build(name)
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
