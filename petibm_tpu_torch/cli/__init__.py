"""Command-line entry points (counterpart of petibm_tpu/cli)."""
