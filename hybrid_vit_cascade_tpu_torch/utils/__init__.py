"""Run logs and inference figures of the port (counterpart of
hybrid_vit_cascade_tpu/utils)."""
