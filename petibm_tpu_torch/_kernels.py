"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` (with the ``csrc/*.cuh`` headers it includes)
exposes a plain C interface and is compiled with
``nvcc`` into a content-hashed shared library under
``build/torch_kernels/`` (at the repository root, git-ignored) at first
use, then loaded with ``ctypes``.  A source without PyTorch headers
builds in seconds, so every fresh checkout builds from its own sources.
Nothing is compiled when this module is imported.  The helpers at the end
bind a C entry point with ctypes and check what a launch takes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: per-source flags.  Every kernel contracts no multiply-add into an FMA,
#: so each rounds op for op as its twin does and equals it bit for bit:
#: PCR on a stretched grid amplifies every rounding difference by the line
#: systems' condition (1e-5 relative at the flagship's 450^2 level in
#: float32 with contraction); K1, K2 and K3 are bound by bytes, and the
#: uncontracted instructions cost K1 and K2 about 1% at 256^3 and 6% at
#: the sphere's shapes in float32 (scripts/bench_torch_stencil.py, variant
#: fma).  The builds report each kernel's registers and spills (ptxas -v).
EXTRA_FLAGS = {name: ("--fmad=false", "-Xptxas", "-v")
               for name in ("line_sweep", "tridiag_pcr", "poisson_separable",
                            "zblocked_helmholtz", "convection3d")}

_LIBS: dict[str, ctypes.CDLL] = {}
#: the compiler's messages of each source built by this process
BUILD_LOGS: dict[str, str] = {}


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
    source, headers and flags exists; returns the library path and the
    build seconds (0.0 when it was already built)."""
    src = _CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, ())
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(flags).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{name}-{digest}.so"
    if so.is_file():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    BUILD_LOGS[name] = proc.stdout + proc.stderr
    os.replace(tmp, so)  # atomic against a build running alongside
    return so, time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use: a
    span ``kernels.<name>`` in the store whose span is open
    (``utils/timers.py``), and its counters ``kernels.builds`` and
    ``kernels.build_s`` where nvcc ran."""
    lib = _LIBS.get(name)
    if lib is None:
        from .utils import timers

        with timers.span(f"kernels.{name}"):
            path, seconds = build(name)
            lib = ctypes.CDLL(str(path))
            if seconds > 0.0:
                timers.add("kernels.builds", 1)
                timers.add("kernels.build_s", seconds)
        _LIBS[name] = lib
    return lib


#: the C entry points' suffix of each dtype; bfloat16 has entries in the
#: multigrid kernels K1, K4/K5 and K6/K7 (the mixed-precision V-cycle)
TYPE_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
               torch.bfloat16: "bf16"}


def c_function(kernel: str, entry: str, dtype: torch.dtype, argtypes: list):
    """The C entry point ``<entry>_<f32|f64|bf16>`` of ``csrc/<kernel>.cu``
    with its ctypes signature set (pointers and the stream as c_void_p, so
    none is cut to 32 bits)."""
    fn = getattr(library(kernel), f"{entry}_{TYPE_SUFFIX[dtype]}")
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def ptr(t):
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_launchable(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} takes contiguous fields")


def check_vectors(name: str, like: torch.Tensor, vecs) -> None:
    for vec in vecs:
        if vec.device != like.device or vec.dtype != like.dtype:
            raise ValueError(f"{name} coefficients must share the field's "
                             f"device and dtype ({like.device}, {like.dtype})")
        if vec.ndim != 1 or not vec.is_contiguous():
            raise ValueError(f"{name} coefficients must be contiguous 1D "
                             "tensors")


def check_dtype(name: str, t: torch.Tensor, bf16: bool = False) -> None:
    """Raise unless ``t`` is float32 or float64, or bfloat16 where the
    kernel has bfloat16 instances (``bf16``)."""
    if t.dtype in (torch.float32, torch.float64):
        return
    if bf16 and t.dtype == torch.bfloat16:
        return
    raise TypeError(f"{name} takes float32 or float64"
                    f"{' or bfloat16' if bf16 else ''}, got {t.dtype}")


def _counters() -> dict:
    """Each kernel's launch counter: (module, wrapper, attribute); K2's
    scaled launches (K2b) are counted again apart from all of K2's."""
    from .linalg import cuda_pcr, cuda_sweep
    from .operators import cuda_stencil as cs

    return {"K1": (cs, "poisson_apply_separable", "launches"),
            "K2": (cs, "zblocked_helmholtz_apply", "launches"),
            "K2 scaled": (cs, "zblocked_helmholtz_apply", "scaled_launches"),
            "K3": (cs, "convection3d_apply", "launches"),
            "K4/K5": (cuda_sweep, "fused_sweep", "launches"),
            "K6/K7": (cuda_pcr, "pcr", "launches")}


def launch_counts() -> dict:
    """Every wrapper's launch count, by kernel."""
    return {name: getattr(getattr(mod, fn), attr)
            for name, (mod, fn, attr) in _counters().items()}


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for mod, fn, attr in _counters().values():
        setattr(getattr(mod, fn), attr, 0)


#: the launch counters on the card while ``count_on_device`` is on: an
#: int64 tensor, one entry a counter of ``_counters()``, and its index
_ON_DEVICE: dict = {}


def count_on_device(device=None) -> None:
    """Count launches on ``device`` too, from 0 (None: stop).  A wrapper
    then adds one to its counter's entry of a device tensor on the stream
    it launched on, which a CUDA graph's capture records beside the
    kernel: a replay counts the launches it makes, in an IF node's body
    only where the body runs.  Inside a masked body (``loops.masked``,
    whose copies all run) a second tensor, ``kept``, adds the body's
    predicate: the launches whose results the step keeps.  A graph
    captured while this is on writes into the tensors; capture it again
    once this is off."""
    _ON_DEVICE.clear()
    if device is None:
        return
    counters = _counters()
    _ON_DEVICE["index"] = {(id(getattr(mod, fn)), attr): i
                           for i, (mod, fn, attr)
                           in enumerate(counters.values())}
    _ON_DEVICE["names"] = list(counters)
    _ON_DEVICE["counts"] = torch.zeros(len(counters), dtype=torch.int64,
                                       device=device)
    _ON_DEVICE["kept"] = torch.zeros_like(_ON_DEVICE["counts"])


def zero_device_launch_counts() -> None:
    """Set the device counters of ``count_on_device`` to 0 in place: a
    graph captured while they were on goes on counting into them."""
    _ON_DEVICE["counts"].zero_()
    _ON_DEVICE["kept"].zero_()


def device_launch_counts(kept: bool = False) -> dict:
    """The device counters of ``count_on_device``, by kernel (one read):
    every launch, or with ``kept`` those whose results were kept."""
    counts = _ON_DEVICE["kept" if kept else "counts"].tolist()
    return dict(zip(_ON_DEVICE["names"], counts))


def count_launch(wrapper, attr: str = "launches") -> None:
    """One more launch in ``wrapper.<attr>``, where the wrapper launched
    its kernel, and on the device while ``count_on_device`` is on.  Under
    a stream capture the launch is recorded into a CUDA graph and runs
    nothing, so the host counts none; the graph's replays do not enter
    the wrapper."""
    if _ON_DEVICE:
        from .linalg.loops import MASK

        i = _ON_DEVICE["index"][id(wrapper), attr]
        _ON_DEVICE["counts"][i].add_(1)
        _ON_DEVICE["kept"][i].add_(MASK[-1].to(torch.int64) if MASK else 1)
    if not torch.cuda.is_current_stream_capturing():
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)
