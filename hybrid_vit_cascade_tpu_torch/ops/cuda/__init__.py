"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions
(counterpart of hybrid_vit_cascade_tpu/ops/pallas)."""
