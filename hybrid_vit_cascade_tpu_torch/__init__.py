"""PyTorch + CUDA port of hybrid_vit_cascade_tpu for NVIDIA Hopper (H100).

The JAX package ``hybrid_vit_cascade_tpu`` is the reference; this package
mirrors its directory and module names. It imports torch and never jax,
nor anything of the JAX package (``config`` is its own copy of the JAX
package's dataclasses).
Kernels that the JAX package wrote in Pallas are hand-written CUDA C++ under
``csrc/``, compiled with nvcc at first use (``ops/cuda/_build.py``).
"""
