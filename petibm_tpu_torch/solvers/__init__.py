"""Flow solvers (counterpart of petibm_tpu/solvers)."""
