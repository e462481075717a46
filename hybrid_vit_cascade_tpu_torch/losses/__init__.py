"""Losses and metrics of the port (counterpart of hybrid_vit_cascade_tpu/losses)."""
