"""Progressive 64³→128³→256³ cascade (counterpart of
hybrid_vit_cascade_tpu/models/cascade.py), inference only.

Stage 1 generates 64³ from a learnable seed volume; stages 2 and 3
trilinearly upsample the previous stage, refine it with a ViT (plus a CNN
detail branch at stage 3) and blend with learned residual weights. Volumes
are NCDHW throughout.

Preserved from the JAX package: stage 1 owns a private MultiScaleXrayEncoder,
distinct from the cascade-level one that stages 2 and 3 both call (shared
weights, two runs). The stage-3 conv chains are evaluated densely
(ops/chain.py); the JAX package's eval schedule streams them and folds
conv→GroupNorm at batch 1, which gives the same result to fp32 tolerance.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.chain import chain_apply_dense
from ..ops.conv3d import ConvNCDHW, GroupNormNCDHW
from ..ops.resize import resize_trilinear
from .encoders import MultiScaleXrayEncoder
from .vit3d import HybridViT3D, _stem_plan


class UpsampleConvBlock(nn.Module):
    """Upsample (×2, trilinear, align_corners=False) → 3×3×3 conv → GN → GELU."""

    def __init__(self, in_channels: int, features: int, groups: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = ConvNCDHW(in_channels, features, dtype=dtype)
        self.norm = GroupNormNCDHW(groups, features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, D, H, W)
        d, h, w = x.shape[2:]
        x = resize_trilinear(x, (2 * d, 2 * h, 2 * w), align_corners=False).to(self.dtype)
        return F.gelu(self.norm(self.conv(x)))


class Stage1Base64(nn.Module):
    """Base reconstruction at stage-1 size from a learnable seed volume."""

    def __init__(self, volume_size=(64, 64, 64), voxel_dim: int = 256, vit_depth: int = 4,
                 num_heads: int = 4, xray_feature_dim: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.xray_encoder = MultiScaleXrayEncoder(xray_feature_dim, stages=(1,), dtype=dtype)
        self.initial_volume = nn.Parameter(0.01 * torch.randn(1, 1, *volume_size))
        self.vit_backbone = HybridViT3D(volume_size, 1, voxel_dim, vit_depth, num_heads,
                                        context_dim=xray_feature_dim, dtype=dtype)

    def forward(self, xrays: torch.Tensor) -> torch.Tensor:
        B = xrays.shape[0]
        feats, cond, _ = self.xray_encoder(xrays, stage=1)
        x = self.initial_volume.expand(B, -1, -1, -1, -1).to(self.dtype)
        context = feats.flatten(2).transpose(1, 2)  # (B, H'·W', E), (H', W') order
        return self.vit_backbone(x, context, cond)  # (B, 1, D, H, W)


class Stage2Refiner128(nn.Module):
    """Stage-1 → stage-2 size: upsample-conv stem → ViT → learned-weight residual."""

    def __init__(self, volume_size=(128, 128, 128), voxel_dim: int = 256, vit_depth: int = 6,
                 num_heads: int = 8, xray_feature_dim: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.volume_size = tuple(volume_size)
        self.upsample_from_64 = UpsampleConvBlock(1, 32, 8, dtype)
        self.vit_refiner = HybridViT3D(volume_size, 32, voxel_dim, vit_depth, num_heads,
                                       context_dim=xray_feature_dim, dtype=dtype)
        self.residual_weight = nn.Parameter(torch.full((1,), 0.5))

    def forward(self, volume_64: torch.Tensor, xray_feats: torch.Tensor,
                cond: torch.Tensor) -> torch.Tensor:
        x = self.upsample_from_64(volume_64)
        refinement = self.vit_refiner(x, xray_feats.flatten(2).transpose(1, 2), cond)
        base = resize_trilinear(volume_64, self.volume_size, align_corners=False)
        return base + self.residual_weight.to(base.dtype) * refinement


class _ChainParams(nn.Module):
    """Owns the conv/GroupNorm parameters of an ops/chain.py spec under the
    JAX package's flat names (``<name>_kernel``, ``<name>_bias``,
    ``<name>_scale``), so one parameter tree serves every chain schedule."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self._spec = []

    def _conv_op(self, name: str, out_ch: int, in_ch: int, k: int, stride: int) -> None:
        bound = 1.0 / math.sqrt(in_ch * k ** 3)  # torch conv default init
        kernel = torch.empty(out_ch, in_ch, k, k, k).uniform_(-bound, bound)
        self.register_parameter(f"{name}_kernel", nn.Parameter(kernel))
        self.register_parameter(f"{name}_bias", nn.Parameter(torch.zeros(out_ch)))
        self._spec.append(("conv", name, stride))

    def _gn_op(self, name: str, ch: int, groups: int) -> None:
        self.register_parameter(f"{name}_scale", nn.Parameter(torch.ones(ch)))
        self.register_parameter(f"{name}_bias", nn.Parameter(torch.zeros(ch)))
        self._spec.append(("gn", name, groups))

    def _act_op(self, name: str) -> None:
        self._spec.append(("act", name))

    def chain(self):
        ops = []
        for op in self._spec:
            if op[0] == "conv":
                ops.append(("conv", getattr(self, f"{op[1]}_kernel"),
                            getattr(self, f"{op[1]}_bias"), op[2]))
            elif op[0] == "gn":
                ops.append(("gn", op[2], getattr(self, f"{op[1]}_scale"),
                            getattr(self, f"{op[1]}_bias")))
            else:
                ops.append(op)
        return ops


class DetailEnhancer(_ChainParams):
    """High-frequency CNN branch on the upsampled base volume:
    conv(1→64)→GN16→GELU→conv(64→32)→GN8→GELU→conv 1×1 (32→1)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self._conv_op("conv0", 64, 1, 3, 1)
        self._gn_op("gn0", 64, 16)
        self._act_op("gelu")
        self._conv_op("conv1", 32, 64, 3, 1)
        self._gn_op("gn1", 32, 8)
        self._act_op("gelu")
        self._conv_op("conv_out", 1, 32, 1, 1)

    def forward(self, base: torch.Tensor) -> torch.Tensor:  # (B, 1, D, H, W)
        return chain_apply_dense(base, self.chain(), self.dtype)


class Stage3ViTTrunk(_ChainParams):
    """×2 trilinear upsample → conv(1→32)+GN+GELU → the ViT's stride-2 token
    stem, as one chain → stage-3 ViT blocks on the token grid."""

    def __init__(self, volume_size: Tuple[int, int, int], voxel_dim: int, vit_depth: int,
                 num_heads: int, xray_feature_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        blocks_ch, last_ch, _ = _stem_plan(volume_size, 32, voxel_dim)
        self._conv_op("upsample_conv", 32, 1, 3, 1)
        self._gn_op("upsample_gn", 32, 8)
        self._act_op("gelu")
        in_ch = 32
        for i, out_ch in enumerate(blocks_ch):
            self._conv_op(f"stem_conv{i}", out_ch, in_ch, 3, 2)
            self._gn_op(f"stem_gn{i}", out_ch, min(8, out_ch))
            self._act_op("silu")
            in_ch = out_ch
        if last_ch != voxel_dim:
            self._conv_op("proj_conv", voxel_dim, in_ch, 3, 1)
        self.vit_refiner = HybridViT3D(volume_size, voxel_dim, voxel_dim, vit_depth, num_heads,
                                       context_dim=xray_feature_dim, dtype=dtype,
                                       external_stem=True)

    def forward(self, vol_nc: torch.Tensor, context: torch.Tensor,
                cond: torch.Tensor) -> torch.Tensor:
        d, h, w = vol_nc.shape[2:]
        x1 = resize_trilinear(vol_nc, (2 * d, 2 * h, 2 * w), align_corners=False).to(self.dtype)
        feat = chain_apply_dense(x1, self.chain(), self.dtype)
        return self.vit_refiner(feat, context, cond)


class Stage3Refiner256(nn.Module):
    """Stage-2 → stage-3 size refiner with the CNN detail branch:
    base + residual_weight·refinement + detail_weight·details."""

    def __init__(self, volume_size=(256, 256, 256), voxel_dim: int = 256, vit_depth: int = 8,
                 num_heads: int = 8, xray_feature_dim: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.volume_size = tuple(volume_size)
        self.vit_trunk = Stage3ViTTrunk(self.volume_size, voxel_dim, vit_depth, num_heads,
                                        xray_feature_dim, dtype)
        self.detail_enhancer = DetailEnhancer(dtype)
        self.residual_weight = nn.Parameter(torch.full((1,), 0.5))
        self.detail_weight = nn.Parameter(torch.full((1,), 0.3))

    def forward(self, volume_128: torch.Tensor, xray_feats: torch.Tensor,
                cond: torch.Tensor) -> torch.Tensor:
        context = xray_feats.flatten(2).transpose(1, 2)
        refinement = self.vit_trunk(volume_128, context, cond)
        base = resize_trilinear(volume_128, self.volume_size, align_corners=False)
        details = self.detail_enhancer(base)
        return (base + self.residual_weight.to(base.dtype) * refinement
                + self.detail_weight.to(base.dtype) * details)


class ProgressiveCascadeModel(nn.Module):
    """Full cascade with per-stage early exit.

    forward(xrays (B, 2, 1, S, S), return_intermediate, max_stage) →
    (B, 1, s, s, s) at the max-stage size, or {"stage1": ..., ...}.

    ``built_stages`` (1-3) builds only the stages up to it — the counterpart
    of the JAX engine's max_stage template, for loading a stage-pruned
    checkpoint."""

    def __init__(self, xray_feature_dim: int = 512, voxel_dim: int = 256,
                 stage_depths=(4, 6, 8), stage_heads=(4, 8, 8), stage_sizes=(64, 128, 256),
                 dtype: torch.dtype = torch.float32, built_stages: int = 3):
        super().__init__()
        self.built_stages = built_stages
        s1, s2, s3 = stage_sizes
        kw = dict(voxel_dim=voxel_dim, xray_feature_dim=xray_feature_dim, dtype=dtype)
        self.stage1 = Stage1Base64((s1,) * 3, vit_depth=stage_depths[0],
                                   num_heads=stage_heads[0], **kw)
        if built_stages >= 2:
            self.xray_encoder = MultiScaleXrayEncoder(xray_feature_dim, stages=(2, 3),
                                                      dtype=dtype)
            self.stage2 = Stage2Refiner128((s2,) * 3, vit_depth=stage_depths[1],
                                           num_heads=stage_heads[1], **kw)
        if built_stages >= 3:
            self.stage3 = Stage3Refiner256((s3,) * 3, vit_depth=stage_depths[2],
                                           num_heads=stage_heads[2], **kw)

    def forward(self, xrays: torch.Tensor, return_intermediate: bool = False,
                max_stage: int = 3):
        if not 1 <= max_stage <= self.built_stages:
            raise ValueError(f"max_stage {max_stage} outside the built stages 1..{self.built_stages}")
        outputs = {"stage1": self.stage1(xrays)}
        if max_stage >= 2:
            feats2, cond, _ = self.xray_encoder(xrays, stage=2)
            outputs["stage2"] = self.stage2(outputs["stage1"], feats2, cond)
        if max_stage >= 3:
            feats3, cond, _ = self.xray_encoder(xrays, stage=3)
            outputs["stage3"] = self.stage3(outputs["stage2"], feats3, cond)
        if return_intermediate:
            return outputs
        return outputs[f"stage{max_stage}"]
