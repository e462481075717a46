"""Multi-head attention core (counterpart of hybrid_vit_cascade_tpu/ops/attention.py).

Shapes: q (B, H, Nq, Dh), k/v (B, H, Nk, Dh) → (B, H, Nq, Dh).

On a CUDA tensor every call launches the flash kernels (forward: kernel A;
backward: kernel D, or kernels L then M when ``FUSED_BWD`` is false;
ops/cuda/flash_attention.py); on a CPU tensor it runs their plain versions.
The forward saves q, k, v, out and the natural-log lse, and the backward
recomputes the probabilities from them, as the JAX package's flash custom
VJP does. Not ported: the head- and
sequence-sharded mesh paths and the token-count threshold of the JAX
dispatcher, which are TPU-mesh and TPU-tiling constructs.
"""

from __future__ import annotations

import os

import torch

from .cuda import flash_attention as fa

# The backward: the fused kernel D (default) or the split kernels L + M. Set
# as the JAX package sets its own switch (ops/pallas/flash_attention.py:70),
# the one HVC_* variable the port reads; callers may set the attribute, which
# every backward reads when it runs.
FUSED_BWD = os.environ.get("HVC_FLASH_FUSED_BWD", "1") != "0"


class _FlashAttention(torch.autograd.Function):
    """(q, k, v) (BH, N, d) → out, with the flash backward as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        out, lse = fa.flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = fa.flash_attention_bwd if FUSED_BWD else fa.flash_attention_bwd_split
        dq, dk, dv = bwd(q, k, v, out, lse, dout.contiguous(), ctx.scale)
        return dq, dk, dv, None


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float | None = None) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v with fp32 softmax statistics and accumulation,
    output in q's dtype; differentiable."""
    B, H, nq, d = q.shape
    nk = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    out = _FlashAttention.apply(q.reshape(B * H, nq, d).contiguous(),
                                k.reshape(B * H, nk, d).contiguous(),
                                v.reshape(B * H, nk, d).contiguous(), scale)
    return out.reshape(B, H, nq, d)
