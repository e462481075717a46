"""Direct regression model (counterpart of hybrid_vit_cascade_tpu/models/direct.py).

X-rays → the BatchNorm conditioning encoder (views folded into the batch,
÷8) → HybridViT3D over a learnable initial volume, cross-attending to the
flattened X-ray feature map. No diffusion, no cascade.

The backbone reproduces the JAX channels-last stem (``layout="NDHWC"``:
flax GroupNorm), its 3×3×3 convs and both attentions on the hand-written
kernels. The encoder gets the 256-wide zero timestep the JAX module feeds
it. No activation checkpointing: the JAX ``build_model`` passes none,
whatever the config's ``use_gradient_checkpointing`` says.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from .attention import capture_attention
from .encoders import XrayConditioningModule
from .layers import number_dropout_sites
from .vit3d import HybridViT3D


class DirectCTRegression(nn.Module):
    """xrays (B, 2, 1, S, S) → volume (B, 1, D, H, W)."""

    def __init__(self, volume_size: Tuple[int, int, int] = (64, 64, 64), voxel_dim: int = 256,
                 vit_depth: int = 4, num_heads: int = 4, xray_feature_dim: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.xray_encoder = XrayConditioningModule(embed_dim=xray_feature_dim, time_embed_dim=256,
                                                   cond_dim=1024, dtype=dtype)
        self.initial_volume = nn.Parameter(0.01 * torch.randn(1, 1, *volume_size))
        self.vit_backbone = HybridViT3D(volume_size, 1, voxel_dim, vit_depth, num_heads,
                                        context_dim=xray_feature_dim, dtype=dtype,
                                        layout="NDHWC")
        number_dropout_sites(self)

    def capture_attention(self):
        """A context manager: the forwards inside it keep every block's
        cross-attention probabilities (the JAX ``store_attention=True``)."""
        return capture_attention(self)

    def forward(self, xrays: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """train: batch-statistics BatchNorm (running statistics updated) and
        dropout seeded from ``generator``, which it then requires."""
        seed = None
        if train:
            if generator is None:
                raise ValueError("train=True draws its dropout seed from a torch.Generator; "
                                 "pass generator=")
            seed = int(torch.randint(0, 1 << 62, (1,), generator=generator,
                                     device=generator.device))
        B = xrays.shape[0]
        dummy_t = torch.zeros((B, 256), dtype=self.dtype, device=xrays.device)
        _, cond, feats = self.xray_encoder(xrays, dummy_t, train)
        x = self.initial_volume.expand(B, -1, -1, -1, -1).to(self.dtype)
        context = feats.flatten(2).transpose(1, 2)  # (B, H'·W', C), (H', W') row-major
        return self.vit_backbone(x, context, cond, seed)
