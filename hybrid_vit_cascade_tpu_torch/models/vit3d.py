"""Hybrid 3D-ViT backbone (counterpart of hybrid_vit_cascade_tpu/models/vit3d.py).

The volume is conv-downsampled to a token grid (≤128³ → 16³ = 4,096 tokens,
256³ → 32³ = 32,768), run through AdaLN-modulated self-attention +
cross-attention blocks, projected to one channel and trilinearly resized back
(align_corners=True). The port's stem is always feature-first (NCDHW) and its
3×3×3 convs run through the hand-written kernels; the JAX package's
channels-last stem (stage 1) computes the same function.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv3d import ConvNCDHW, GroupNormNCDHW
from ..ops.resize import resize_trilinear
from .attention import MultiHeadCrossAttention, MultiHeadSelfAttention
from .layers import AdaLNModulation, LayerNorm, Linear, Mlp


class HybridViTBlock3D(nn.Module):
    """Pre-norm block: AdaLN-modulated self-attn → un-modulated, ungated
    cross-attn to X-ray tokens → AdaLN-modulated MLP."""

    def __init__(self, voxel_dim: int, num_heads: int = 8, context_dim: int = 512,
                 cond_dim: int = 1024, mlp_ratio: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.adaln = AdaLNModulation(cond_dim, voxel_dim, dtype)
        self.norm1 = LayerNorm(voxel_dim, dtype)
        self.self_attn = MultiHeadSelfAttention(voxel_dim, num_heads, dtype)
        self.norm2 = LayerNorm(voxel_dim, dtype)
        self.cross_attn = MultiHeadCrossAttention(voxel_dim, context_dim, num_heads, dtype)
        self.norm3 = LayerNorm(voxel_dim, dtype)
        self.mlp = Mlp(voxel_dim, voxel_dim * mlp_ratio, voxel_dim, dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        # x (B, N, voxel_dim), context (B, M, context_dim), cond (B, cond_dim)
        shift_sa, scale_sa, gate_sa, shift_mlp, scale_mlp, gate_mlp = self.adaln(cond)
        h = (1.0 + scale_sa) * self.norm1(x) + shift_sa
        x = x + gate_sa * self.self_attn(h)
        x = x + self.cross_attn(self.norm2(x), context)
        h = (1.0 + scale_mlp) * self.norm3(x) + shift_mlp
        return x + gate_mlp * self.mlp(h)


def _stem_plan(volume_size: Tuple[int, int, int], in_channels: int, voxel_dim: int):
    """Greedy stride-2 plan + channel schedule, copied from the JAX package
    (models/vit3d.py:98-131): token budget ≤128³ → 16³, >128³ → 32³; channels
    walk in → vd/4 → vd/2 → vd (then stay at vd). Returns (per-block output
    channels, last channel count, token grid)."""
    d = max(volume_size)
    target = 16 if d <= 128 else 32
    factor = max(1, max(s // target for s in volume_size))
    blocks = []
    current = in_channels
    remaining = factor
    n = 0
    while remaining > 1:
        if current == in_channels:
            out = voxel_dim // 4
        elif n < 2:
            out = voxel_dim // 2
        else:
            out = voxel_dim
        blocks.append(out)
        current = out
        remaining //= 2
        n += 1
    realized = 2 ** len(blocks)
    down = tuple(s // realized for s in volume_size)
    return blocks, current, down


class HybridViT3D(nn.Module):
    """Backbone for one cascade stage: (B, C, D, H, W) → (B, 1, D, H, W).

    external_stem=True: the caller already ran the token stem and passes the
    (B, voxel_dim, Dd, Hd, Wd) feature map (stage 3's fused chain)."""

    def __init__(self, volume_size: Tuple[int, int, int], in_channels: int, voxel_dim: int,
                 depth: int, num_heads: int, context_dim: int = 512, cond_dim: int = 1024,
                 dtype: torch.dtype = torch.float32, external_stem: bool = False):
        super().__init__()
        self.volume_size = tuple(volume_size)
        self.voxel_dim = voxel_dim
        self.dtype = dtype
        self.external_stem = external_stem
        blocks_ch, last_ch, down = _stem_plan(self.volume_size, in_channels, voxel_dim)
        self.stem_convs = nn.ModuleList()
        self.stem_norms = nn.ModuleList()
        self.proj = None
        if not external_stem:
            cin = in_channels
            for out_ch in blocks_ch:
                self.stem_convs.append(ConvNCDHW(cin, out_ch, stride=2, dtype=dtype))
                self.stem_norms.append(GroupNormNCDHW(min(8, out_ch), out_ch, dtype))
                cin = out_ch
            if last_ch != voxel_dim:
                self.proj = ConvNCDHW(cin, voxel_dim, dtype=dtype)
        n_tokens = down[0] * down[1] * down[2]
        self.pos_embed = nn.Parameter(0.02 * torch.randn(1, n_tokens, voxel_dim))
        self.blocks = nn.ModuleList(
            HybridViTBlock3D(voxel_dim, num_heads, context_dim, cond_dim, dtype=dtype)
            for _ in range(depth))
        self.norm = LayerNorm(voxel_dim, dtype)
        self.head = Linear(voxel_dim, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        h = x.to(self.dtype)
        if self.external_stem:
            if h.shape[1] != self.voxel_dim:
                raise ValueError(f"external stem must give {self.voxel_dim} channels, got {h.shape}")
        else:
            for conv, norm in zip(self.stem_convs, self.stem_norms):
                h = F.silu(norm(conv(h)))
            if self.proj is not None:
                h = self.proj(h)
        Dd, Hd, Wd = h.shape[2:]
        # (B, C, Dd, Hd, Wd) → (B, N, C): tokens in (D, H, W) row-major order
        tokens = h.flatten(2).transpose(1, 2) + self.pos_embed.to(self.dtype)
        for blk in self.blocks:
            tokens = blk(tokens, context, cond)
        out = self.head(self.norm(tokens)).reshape(B, 1, Dd, Hd, Wd)
        return resize_trilinear(out, self.volume_size, align_corners=True)
