"""petibm_tpu_torch — the PyTorch/CUDA port of petibm_tpu.

The JAX package ``petibm_tpu`` is the reference; this package mirrors its
module names so each counterpart is easy to find.  Plain tensor code is
PyTorch; every TPU kernel of the JAX package (K1-K7) is a hand-written
CUDA kernel under ``csrc/``, built with nvcc at first use and bound with
ctypes (``_kernels.py``, ``operators/cuda_stencil.py``,
``linalg/cuda_sweep.py``, ``linalg/cuda_pcr.py``).

The solvers and both CLIs run on the card: ``device=None`` (``-device``
omitted) means cuda and raises where no card is found.  The CPU is used
only when asked for (``device="cpu"``, ``-device cpu``), as the tests do;
on CPU tensors each kernel's wrapper runs its plain PyTorch twin.

Setup math (eigendecompositions, dense force-block inverses) runs in host
numpy float64 and is moved to the device once.  Fields default to
float32; ``parameters.dtype`` is honoured.  This package never imports
jax: the numpy-only host modules of the JAX package are copied here
(held equal to their originals by ``tests/test_torch_host.py``) because
``petibm_tpu/__init__.py`` imports jax.
"""

__version__ = "0.1.0"
