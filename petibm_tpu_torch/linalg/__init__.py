"""Linear solvers of the port (counterpart of petibm_tpu/linalg)."""
