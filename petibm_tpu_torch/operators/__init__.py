"""Stencil operators and hand-written kernels (counterpart of
petibm_tpu/operators)."""
