"""Tensor ops of the port (counterpart of hybrid_vit_cascade_tpu/ops)."""
