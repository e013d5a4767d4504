"""Lagrangian bodies, delta kernels and the interpolation/spreading
(E/H) operators (counterpart of petibm_tpu/ibm)."""
