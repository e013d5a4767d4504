"""petibm_tpu_torch — the PyTorch/CUDA port of petibm_tpu.

The JAX package ``petibm_tpu`` is the reference; this package mirrors its
module names so each counterpart is easy to find.  Plain tensor code is
PyTorch; the one TPU kernel on the 2D decoupled-IBPM path (the separable
pressure Poisson apply) is a hand-written CUDA kernel
(``csrc/poisson_separable.cu``, bound in ``operators/cuda_stencil.py``).

Setup math (eigendecompositions, dense force-block inverses) runs in host
numpy float64 and is moved to the device once.  Fields default to
float32; ``parameters.dtype`` is honoured.  This package never imports
jax: the numpy-only host modules of the JAX package are copied here
(held equal to their originals by ``tests/test_torch_host.py``) because
``petibm_tpu/__init__.py`` imports jax.
"""

__version__ = "0.1.0"
