"""Measurement entry points of the port (``python -m
hybrid_vit_cascade_tpu_torch.scripts.<name>``)."""
