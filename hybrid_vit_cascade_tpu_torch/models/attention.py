"""Multi-head self/cross attention (counterpart of
hybrid_vit_cascade_tpu/models/attention.py:42-109).

The core runs through ops.attention, which launches the flash kernels on a
CUDA tensor. Dropout acts on the attention output and after the output
projection, as in the JAX package (README deviation 3: not on the
probabilities).

The cross-attention capture: ``capture_attention`` sets
``store_attention`` on every ``MultiHeadCrossAttention`` under a module for
the forwards of a ``with`` block; each then takes the plain
score-materialising path and keeps the detached fp32 probabilities
(B, H, N, M) in ``attention_weights``, as the JAX module sows them, and
``collect_attention_maps`` gathers what was kept.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn

from ..ops.attention import dot_product_attention
from .layers import DROPOUT_RATE, Dropout, Linear


def collect_attention_maps(model: nn.Module) -> dict:
    """The cross-attention probabilities kept by the capturing modules of
    ``model`` (in ``model.modules()`` order) → {"cross_attention": the mean
    over those whose map has the first map's shape}, or {} when none
    captured: the dict DiagnosticLosses consumes."""
    maps = [m.attention_weights for m in model.modules()
            if isinstance(m, MultiHeadCrossAttention) and m.attention_weights is not None]
    if not maps:
        return {}
    same = [m for m in maps if m.shape == maps[0].shape]
    return {"cross_attention": sum(same) / len(same)}


@contextlib.contextmanager
def capture_attention(module: nn.Module):
    """Every cross-attention under ``module`` captures in the forwards inside
    the ``with`` block; on exit the flags are cleared and the kept maps
    dropped, so later forwards take the kernel path and hold no maps."""
    mods = [m for m in module.modules() if isinstance(m, MultiHeadCrossAttention)]
    for m in mods:
        m.store_attention, m.attention_weights = True, None
    try:
        yield
    finally:
        for m in mods:
            m.store_attention, m.attention_weights = False, None


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
    bias, the output projection does. kv splits as (B, M, 2, H, Dh).

    store_attention (set by ``capture_attention``): take the plain path and
    keep the detached fp32 probabilities of the last forward in
    ``attention_weights``."""

    def __init__(self, embed_dim: int, context_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.store_attention = False
        self.attention_weights: torch.Tensor | None = None
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
        if self.store_attention:
            out, probs = dot_product_attention(q, kv[0], kv[1], scale=Dh ** -0.5,
                                               return_probs=True)
            self.attention_weights = probs.detach()
        else:
            out = dot_product_attention(q, kv[0], kv[1], scale=Dh ** -0.5)
        out = self.drop_attn(out.transpose(1, 2).reshape(B, N, E), seed)
        return self.drop_proj(self.proj(out), seed)
