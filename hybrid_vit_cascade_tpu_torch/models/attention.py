"""Multi-head self/cross attention (counterpart of
hybrid_vit_cascade_tpu/models/attention.py:42-109).

The core runs through ops.attention, which launches the flash kernels on a
CUDA tensor. Dropout acts on the attention output and after the output
projection, as in the JAX package (README deviation 3: not on the
probabilities). The cross-attention ``store_attention`` capture is not
ported yet.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.attention import dot_product_attention
from .layers import DROPOUT_RATE, Dropout, Linear


class MultiHeadSelfAttention(nn.Module):
    """Fused-qkv softmax MHSA over voxel tokens; qkv has no bias, the output
    projection does. qkv splits as (B, N, 3, H, Dh)."""

    def __init__(self, embed_dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(embed_dim, 3 * embed_dim, bias=False, dtype=dtype)
        self.proj = Linear(embed_dim, embed_dim, dtype=dtype)
        self.drop_attn = Dropout(DROPOUT_RATE)
        self.drop_proj = Dropout(DROPOUT_RATE)

    def forward(self, x: torch.Tensor, seed: int | None = None) -> torch.Tensor:
        B, N, E = x.shape
        H = self.num_heads
        Dh = E // H
        qkv = self.qkv(x).reshape(B, N, 3, H, Dh).permute(2, 0, 3, 1, 4)  # (3, B, H, N, Dh)
        out = dot_product_attention(qkv[0], qkv[1], qkv[2], scale=Dh ** -0.5)
        out = self.drop_attn(out.transpose(1, 2).reshape(B, N, E), seed)
        return self.drop_proj(self.proj(out), seed)


class MultiHeadCrossAttention(nn.Module):
    """Q from voxel tokens, K/V from X-ray feature tokens; q and kv have no
    bias, the output projection does. kv splits as (B, M, 2, H, Dh)."""

    def __init__(self, embed_dim: int, context_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.q = Linear(embed_dim, embed_dim, bias=False, dtype=dtype)
        self.kv = Linear(context_dim, 2 * embed_dim, bias=False, dtype=dtype)
        self.proj = Linear(embed_dim, embed_dim, dtype=dtype)
        self.drop_attn = Dropout(DROPOUT_RATE)
        self.drop_proj = Dropout(DROPOUT_RATE)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                seed: int | None = None) -> torch.Tensor:
        B, N, E = x.shape
        M = context.shape[1]
        H = self.num_heads
        Dh = E // H
        q = self.q(x).reshape(B, N, H, Dh).transpose(1, 2)
        kv = self.kv(context).reshape(B, M, 2, H, Dh).permute(2, 0, 3, 1, 4)
        out = dot_product_attention(q, kv[0], kv[1], scale=Dh ** -0.5)
        out = self.drop_attn(out.transpose(1, 2).reshape(B, N, E), seed)
        return self.drop_proj(self.proj(out), seed)
