"""Host utilities (counterpart of petibm_tpu/utils)."""
