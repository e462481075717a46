"""Multi-head attention core (counterpart of hybrid_vit_cascade_tpu/ops/attention.py).

Shapes: q (B, H, Nq, Dh), k/v (B, H, Nk, Dh) → (B, H, Nq, Dh).

On a CUDA tensor every call launches the flash kernel (kernel A,
ops/cuda/flash_attention.py); on a CPU tensor it runs the kernel's plain
exact-softmax version. Not ported: the head- and sequence-sharded mesh paths
and the token-count threshold of the JAX dispatcher, which are TPU-mesh and
TPU-tiling constructs.
"""

from __future__ import annotations

import torch

from .cuda.flash_attention import flash_attention_fwd


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float | None = None) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v with fp32 softmax statistics and accumulation,
    output in q's dtype."""
    B, H, nq, d = q.shape
    nk = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    out, _ = flash_attention_fwd(q.reshape(B * H, nq, d).contiguous(),
                                 k.reshape(B * H, nk, d).contiguous(),
                                 v.reshape(B * H, nk, d).contiguous(), scale)
    return out.reshape(B, H, nq, d)
