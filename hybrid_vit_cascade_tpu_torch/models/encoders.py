"""X-ray CNN encoders (counterpart of hybrid_vit_cascade_tpu/models/encoders.py).

Feature maps are NCHW here (the JAX package is channels-last); the X-ray
input keeps the reference layout (B, V, 1, H, W). The 2D convs, BatchNorm
and max pooling are plain torch ops, as the JAX package leaves them to XLA.
BatchNorm and the down blocks' GroupNorm follow flax's numerics (statistics,
normalisation and affine in fp32, then one cast to the compute dtype).
``train=True`` normalises BatchNorm with the batch statistics and updates
the running ones, as flax does under ``mutable=["batch_stats"]``.

``SimpleXrayEncoder`` and ``XRayEncoderB200`` (the CNN decoders' encoders)
take the two views as two input channels and keep flax's auto-names
(``Conv_i``, ``GroupNorm_i``) as module names, so ``convert.flax_tree``
walks them and ``shape_matched_transfer`` pairs what the JAX function pairs.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv3d import GroupNormNCDHW, group_norm_groups
from ..ops.pool import max_pool_nd
from .layers import Linear


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in ``dtype`` over fp32 parameters."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1, padding: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, k, stride=stride, padding=padding)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride, self.padding)


class BatchNorm2d(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` on NCHW in fp32,
    output in ``dtype``. flax's momentum 0.9 keeps 0.9 of the running value,
    torch's ``momentum=0.1`` names the same update; the running variance is
    updated with the biased batch variance (torch's own would use the
    unbiased one), so the update is written out here."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__(channels, eps=1e-5, momentum=0.1)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.float()
        if train:
            mean = xf.mean(dim=(0, 2, 3))
            var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(m * mean.detach())
                self.running_var.mul_(1.0 - m).add_(m * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.compute_dtype)


class XrayConditioningModule(nn.Module):
    """2D CNN conditioning encoder: views folded into the batch, BN/ReLU/
    max-pool stem, views averaged, global context + time conditioning.

    Returns (xray_context (B, cond_dim), time_xray_cond (B, cond_dim),
    features (B, embed_dim, H/8, W/8))."""

    def __init__(self, embed_dim: int = 256, time_embed_dim: int = 256, cond_dim: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(1, 64, 7, stride=2, padding=3, dtype=dtype)
        self.bn1 = BatchNorm2d(64, dtype)
        self.conv2 = Conv2d(64, 128, 3, padding=1, dtype=dtype)
        self.bn2 = BatchNorm2d(128, dtype)
        self.conv3 = Conv2d(128, embed_dim, 3, padding=1, dtype=dtype)
        self.bn3 = BatchNorm2d(embed_dim, dtype)
        self.to_cond = Linear(embed_dim, cond_dim, dtype=dtype)
        self.time1 = Linear(time_embed_dim, 2 * time_embed_dim, dtype=dtype)
        self.time2 = Linear(2 * time_embed_dim, cond_dim, dtype=dtype)

    def forward(self, xrays: torch.Tensor, t_embed: torch.Tensor, train: bool = False):
        B, V = xrays.shape[:2]
        x = xrays.to(self.dtype).reshape(B * V, *xrays.shape[2:])  # views folded into batch
        x = max_pool_nd(F.relu(self.bn1(self.conv1(x), train)), 3, stride=2, padding=1)
        x = max_pool_nd(F.relu(self.bn2(self.conv2(x), train)), 2, stride=2)
        x = F.relu(self.bn3(self.conv3(x), train))
        features = x.reshape(B, V, *x.shape[1:]).mean(dim=1)  # average views
        xray_context = self.to_cond(features.mean(dim=(2, 3)))
        t = self.time2(F.silu(self.time1(t_embed)))
        return xray_context, t + xray_context, features


class _DownBlock(nn.Module):
    """Stride-2 3×3 conv → GroupNorm(32) → GELU."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.conv = Conv2d(dim, dim, 3, stride=2, padding=1, dtype=dtype)
        self.norm = GroupNormNCDHW(32, dim, dtype, flax=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.norm(self.conv(x)))


# per-stage branches: stage 1 gets ÷4 features, stage 2 ÷2, stage 3 the full map
_BRANCHES = {1: ("to_stage1_a", "to_stage1_b"), 2: ("to_stage2",), 3: ()}


class MultiScaleXrayEncoder(nn.Module):
    """Shared conditioning encoder + per-stage conv-downsample branches.

    ``stages`` names the stages this instance serves: the JAX module creates a
    branch's parameters only when that stage calls it, so stage 1's private
    encoder holds the stage-1 branch and the cascade-level one the stage-2
    branch."""

    def __init__(self, base_dim: int = 512, stages: Sequence[int] = (1, 2, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stages = tuple(stages)
        self.xray_encoder = XrayConditioningModule(embed_dim=base_dim, dtype=dtype)
        self.down = nn.ModuleDict(
            {name: _DownBlock(base_dim, dtype) for s in self.stages for name in _BRANCHES[s]})

    def forward(self, xrays: torch.Tensor, stage: int = 1, train: bool = False):
        """→ (features (B, base_dim, h, w), time_xray_cond, xray_context)."""
        if stage not in self.stages:
            raise ValueError(f"this encoder serves stages {self.stages}, not {stage}")
        B = xrays.shape[0]
        dummy_t = torch.zeros((B, 256), dtype=self.dtype, device=xrays.device)
        xray_context, time_xray_cond, feats = self.xray_encoder(xrays, dummy_t, train)
        for name in _BRANCHES[stage]:
            feats = self.down[name](feats)
        return feats, time_xray_cond, xray_context


class _ViewsAsChannelsEncoder(nn.Module):
    """(B, 2, 1, H, W) → (B, C, H/16, W/16): four stride-2 conv → GroupNorm
    (flax numerics) → act stages over the two views as channels."""

    def __init__(self, plan, act, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.act = act
        self.n = len(plan)
        cin = 2
        for i, (ch, k, s, p, g) in enumerate(plan):
            self.add_module(f"Conv_{i}", Conv2d(cin, ch, k, stride=s, padding=p, dtype=dtype))
            self.add_module(f"GroupNorm_{i}",
                            GroupNormNCDHW(group_norm_groups(g, ch), ch, dtype, flax=True))
            cin = ch

    def forward(self, xrays: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = xrays[:, :, 0].to(self.dtype)  # (B, V, H, W): views as channels
        for i in range(self.n):
            x = self.act(getattr(self, f"GroupNorm_{i}")(getattr(self, f"Conv_{i}")(x)))
        return x


class SimpleXrayEncoder(_ViewsAsChannelsEncoder):
    """The H200 CNN decoders' encoder: 64/128/256/feature_dim channels, GELU
    (JAX ``encoders.py:123``)."""

    def __init__(self, feature_dim: int = 512, dtype: torch.dtype = torch.float32):
        plan = [(64, 7, 2, 3, 16), (128, 3, 2, 1, 32), (256, 3, 2, 1, 64),
                (feature_dim, 3, 2, 1, 64)]
        super().__init__(plan, F.gelu, dtype)


class XRayEncoderB200(_ViewsAsChannelsEncoder):
    """The B200 decoder's 128-channel encoder: 32/64/96/128 channels, ReLU
    (JAX ``encoders.py:141``)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        plan = [(32, 7, 2, 3, 8), (64, 3, 2, 1, 8), (96, 3, 2, 1, 16), (128, 3, 2, 1, 16)]
        super().__init__(plan, F.relu, dtype)
