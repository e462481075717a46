"""Inference surface of the port (counterpart of hybrid_vit_cascade_tpu/inference)."""
