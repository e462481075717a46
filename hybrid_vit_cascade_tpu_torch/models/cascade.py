"""Progressive 64³→128³→256³ cascade (counterpart of
hybrid_vit_cascade_tpu/models/cascade.py).

Stage 1 generates 64³ from a learnable seed volume; stages 2 and 3
trilinearly upsample the previous stage, refine it with a ViT (plus a CNN
detail branch at stage 3) and blend with learned residual weights. Volumes
are NCDHW throughout.

Preserved from the JAX package: stage 1 owns a private MultiScaleXrayEncoder,
distinct from the cascade-level one that stages 2 and 3 both call (shared
weights, two runs).

The stage-3 conv chains (the upsample conv + token stem, and the detail
enhancer) run on the schedule the JAX package picks per call
(``Stage3Refiner256._schedule``, ``cascade.py:310-314``), keyed on ``train``:
- ``train=False`` with ``stage3_eval_schedule="auto"`` (the default): the
  streamed slab schedule with one slab and every endpoint stored
  (``ops/slab.py:chain_apply_streamed``), whatever the training flags say;
- otherwise the configured flags: ``stage3_slab_scan`` with ``slab_count``
  slabs of ``slab_impl`` ('streamed' | 'recompute'), or the dense chain.
All schedules share one parameter tree and agree to fp32 tolerance.

Training, as the JAX module runs it (``cascade.py:410-525``):
- ``train=True`` puts every BatchNorm in batch-statistics mode and updates
  its running statistics, frozen stages included, and turns on dropout,
  whose seed is drawn once per forward from the caller's ``generator``.
- ``stop_grad_stage1`` cuts the backward at stage 1's output (``.detach()``
  of the JAX ``stop_gradient``); stage 1 then runs without recording.
- With ``use_gradient_checkpointing``, stage 3 recomputes in the backward:
  the ViT blocks by ``remat_mode``; with ``train=True`` and no slab
  streaming also the upsample conv chain and the ViT trunk as one region
  (``cascade.py:324-331``) and the detail enhancer's dense chain as another
  (``:352``). Under slab streaming each slab body is its own recompute region
  instead. Stages 1 and 2 do not recompute, as in JAX. Checkpointing applies
  only while autograd records.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.slab import chain_apply_dense, chain_apply_slab, chain_apply_streamed
from ..ops.conv3d import ConvNCDHW, GroupNormNCDHW
from ..ops.resize import resize_trilinear
from .attention import capture_attention
from .encoders import MultiScaleXrayEncoder
from .layers import number_dropout_sites
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
                                        context_dim=xray_feature_dim, dtype=dtype,
                                        layout="NDHWC")

    def forward(self, xrays: torch.Tensor, train: bool = False,
                seed: int | None = None) -> torch.Tensor:
        B = xrays.shape[0]
        feats, cond, _ = self.xray_encoder(xrays, stage=1, train=train)
        x = self.initial_volume.expand(B, -1, -1, -1, -1).to(self.dtype)
        context = feats.flatten(2).transpose(1, 2)  # (B, H'·W', E), (H', W') order
        return self.vit_backbone(x, context, cond, seed)  # (B, 1, D, H, W)


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
                cond: torch.Tensor, seed: int | None = None) -> torch.Tensor:
        x = self.upsample_from_64(volume_64)
        refinement = self.vit_refiner(x, xray_feats.flatten(2).transpose(1, 2), cond, seed)
        base = resize_trilinear(volume_64, self.volume_size, align_corners=False)
        return base + self.residual_weight.to(base.dtype) * refinement


# (slab_scan, slab_count, slab_impl, store_min_flops): how a chain runs
Schedule = Tuple[bool, int, str, Optional[float]]


def apply_chain(x: torch.Tensor, chain, dtype: torch.dtype, schedule: Schedule,
                remat: bool = False) -> torch.Tensor:
    """Run an ops/slab.py chain on `schedule` (the JAX modules' dispatch,
    ``cascade.py:189-198, 248-255``); `remat` checkpoints the dense chain."""
    slab_scan, slab_count, slab_impl, store_min_flops = schedule
    if slab_scan:
        if slab_impl == "streamed":
            kw = {} if store_min_flops is None else {"store_min_flops": store_min_flops}
            return chain_apply_streamed(x, chain, slab_count, dtype=dtype, **kw)
        if slab_impl != "recompute":
            raise ValueError(f"slab_impl must be 'streamed' or 'recompute', got {slab_impl!r}")
        return chain_apply_slab(x, chain, slab_count, dtype=dtype)
    if remat and torch.is_grad_enabled():
        return checkpoint(chain_apply_dense, x, chain, dtype, use_reentrant=False)
    return chain_apply_dense(x, chain, dtype)


class _ChainParams(nn.Module):
    """Owns the conv/GroupNorm parameters of an ops/slab.py spec under the
    JAX package's flat names (``<name>_kernel``, ``<name>_bias``,
    ``<name>_scale``), so one parameter tree serves every chain schedule.
    The schedule comes with each call: Stage3Refiner256 picks it (the JAX
    modules carry it as fields because flax builds them per call)."""

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
    conv(1→64)→GN16→GELU→conv(64→32)→GN8→GELU→conv 1×1 (32→1); with
    ``remat`` the dense chain is recomputed in the backward."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self._conv_op("conv0", 64, 1, 3, 1)
        self._gn_op("gn0", 64, 16)
        self._act_op("gelu")
        self._conv_op("conv1", 32, 64, 3, 1)
        self._gn_op("gn1", 32, 8)
        self._act_op("gelu")
        self._conv_op("conv_out", 1, 32, 1, 1)

    def forward(self, base: torch.Tensor, schedule: Schedule,
                remat: bool = False) -> torch.Tensor:  # (B, 1, D, H, W)
        return apply_chain(base, self.chain(), self.dtype, schedule, remat)


class Stage3ViTTrunk(_ChainParams):
    """×2 trilinear upsample → conv(1→32)+GN+GELU → the ViT's stride-2 token
    stem, as one chain → stage-3 ViT blocks on the token grid."""

    def __init__(self, volume_size: Tuple[int, int, int], voxel_dim: int, vit_depth: int,
                 num_heads: int, xray_feature_dim: int, dtype: torch.dtype = torch.float32,
                 inner_remat: bool = False, remat_mode: str = "block"):
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
                                       external_stem=True, remat=inner_remat,
                                       remat_mode=remat_mode)

    def forward(self, vol_nc: torch.Tensor, context: torch.Tensor, cond: torch.Tensor,
                seed: Optional[int], schedule: Schedule) -> torch.Tensor:
        d, h, w = vol_nc.shape[2:]
        x1 = resize_trilinear(vol_nc, (2 * d, 2 * h, 2 * w), align_corners=False).to(self.dtype)
        feat = apply_chain(x1, self.chain(), self.dtype, schedule)
        return self.vit_refiner(feat, context, cond, seed)


class Stage3Refiner256(nn.Module):
    """Stage-2 → stage-3 size refiner with the CNN detail branch:
    base + residual_weight·refinement + detail_weight·details.

    ``slab_scan``/``slab_count``/``slab_impl``/``store_min_flops``: the
    training schedule of the two conv chains (ops/slab.py). ``eval_schedule``
    'auto' runs every ``train=False`` call streamed with one slab and every
    endpoint stored; 'train' keeps the training flags."""

    def __init__(self, volume_size=(256, 256, 256), voxel_dim: int = 256, vit_depth: int = 8,
                 num_heads: int = 8, xray_feature_dim: int = 512,
                 dtype: torch.dtype = torch.float32, remat: bool = True,
                 remat_mode: str = "block", slab_scan: bool = False, slab_count: int = 8,
                 slab_impl: str = "streamed", store_min_flops: Optional[float] = None,
                 eval_schedule: str = "auto"):
        super().__init__()
        if eval_schedule not in ("auto", "train"):
            raise ValueError(f"eval_schedule must be 'auto' or 'train', got {eval_schedule!r}")
        self.volume_size = tuple(volume_size)
        self.remat = remat
        self.slab_scan, self.slab_count = slab_scan, slab_count
        self.slab_impl, self.store_min_flops = slab_impl, store_min_flops
        self.eval_schedule = eval_schedule
        self.vit_trunk = Stage3ViTTrunk(self.volume_size, voxel_dim, vit_depth, num_heads,
                                        xray_feature_dim, dtype, inner_remat=remat,
                                        remat_mode=remat_mode)
        self.detail_enhancer = DetailEnhancer(dtype)
        self.residual_weight = nn.Parameter(torch.full((1,), 0.5))
        self.detail_weight = nn.Parameter(torch.full((1,), 0.3))

    def _schedule(self, train: bool) -> Schedule:
        """The chains' schedule for this call (``cascade.py:310-314``)."""
        if not train and self.eval_schedule == "auto":
            return True, 1, "streamed", 0.0
        return self.slab_scan, self.slab_count, self.slab_impl, self.store_min_flops

    def forward(self, volume_128: torch.Tensor, xray_feats: torch.Tensor,
                cond: torch.Tensor, seed: int | None = None, train: bool = False) -> torch.Tensor:
        schedule = self._schedule(train)
        remat = self.remat and train and not schedule[0]
        context = xray_feats.flatten(2).transpose(1, 2)
        if remat and torch.is_grad_enabled():
            refinement = checkpoint(self.vit_trunk, volume_128, context, cond, seed, schedule,
                                    use_reentrant=False)
        else:
            refinement = self.vit_trunk(volume_128, context, cond, seed, schedule)
        base = resize_trilinear(volume_128, self.volume_size, align_corners=False)
        details = self.detail_enhancer(base, schedule, remat)
        return (base + self.residual_weight.to(base.dtype) * refinement
                + self.detail_weight.to(base.dtype) * details)


class ProgressiveCascadeModel(nn.Module):
    """Full cascade with per-stage early exit.

    forward(xrays (B, 2, 1, S, S), return_intermediate, max_stage) →
    (B, 1, s, s, s) at the max-stage size, or {"stage1": ..., ...}.

    ``built_stages`` (1-3) builds only the stages up to it — the counterpart
    of the JAX engine's max_stage template, for loading a stage-pruned
    checkpoint. ``use_gradient_checkpointing`` and ``remat_mode`` are the
    config's (stage 3 only, as in JAX), as are ``stage3_slab_scan``,
    ``slab_count`` and ``slab_impl``; ``stage3_store_min_flops`` and
    ``stage3_eval_schedule`` are the JAX module's fields (Stage3Refiner256)."""

    def __init__(self, xray_feature_dim: int = 512, voxel_dim: int = 256,
                 stage_depths=(4, 6, 8), stage_heads=(4, 8, 8), stage_sizes=(64, 128, 256),
                 dtype: torch.dtype = torch.float32, built_stages: int = 3,
                 use_gradient_checkpointing: bool = True, remat_mode: str = "block",
                 stage3_slab_scan: bool = False, slab_count: int = 8,
                 slab_impl: str = "streamed", stage3_store_min_flops: Optional[float] = None,
                 stage3_eval_schedule: str = "auto"):
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
                                           num_heads=stage_heads[2],
                                           remat=use_gradient_checkpointing,
                                           remat_mode=remat_mode, slab_scan=stage3_slab_scan,
                                           slab_count=slab_count, slab_impl=slab_impl,
                                           store_min_flops=stage3_store_min_flops,
                                           eval_schedule=stage3_eval_schedule, **kw)
        number_dropout_sites(self)

    def capture_attention(self):
        """A context manager: the forwards inside it capture stage 1's
        cross-attention probabilities (what JAX's ``clone(store_attention=True)``
        does, for one ``with`` block; maps dropped on exit). Only stage 1
        captures, as in JAX."""
        return capture_attention(self.stage1)

    def forward(self, xrays: torch.Tensor, return_intermediate: bool = False,
                max_stage: int = 3, train: bool = False, stop_grad_stage1: bool = False,
                generator: torch.Generator | None = None,
                stage2_volume: torch.Tensor | None = None):
        """train: batch-statistics BatchNorm (running statistics updated) and
        dropout seeded from ``generator``, which it then requires.

        stage2_volume: a precomputed (B, 1, s2, s2, s2) stage-2 output; with
        it (and max_stage=3) stages 1-2 are skipped, the shared encoder runs
        only for stage 3 and stage 3 refines this volume (the JAX module's
        argument, which the trainer's split stage-3 step feeds)."""
        if not 1 <= max_stage <= self.built_stages:
            raise ValueError(f"max_stage {max_stage} outside the built stages 1..{self.built_stages}")
        if stage2_volume is not None and max_stage < 3:
            raise ValueError("stage2_volume requires max_stage=3")
        seed = None
        if train:
            if generator is None:
                raise ValueError("train=True draws its dropout seed from a torch.Generator; "
                                 "pass generator=")
            seed = int(torch.randint(0, 1 << 62, (1,), generator=generator,
                                     device=generator.device))
        outputs = {}
        if stage2_volume is None:
            cut = stop_grad_stage1 and max_stage >= 2
            with torch.set_grad_enabled(torch.is_grad_enabled() and not cut):
                vol64 = self.stage1(xrays, train, seed)
            outputs["stage1"] = vol64.detach() if cut else vol64
            if max_stage >= 2:
                feats2, cond, _ = self.xray_encoder(xrays, stage=2, train=train)
                outputs["stage2"] = self.stage2(outputs["stage1"], feats2, cond, seed)
        if max_stage >= 3:
            vol128 = outputs["stage2"] if stage2_volume is None else stage2_volume
            feats3, cond, _ = self.xray_encoder(xrays, stage=3, train=train)
            outputs["stage3"] = self.stage3(vol128, feats3, cond, seed, train)
        if return_intermediate:
            return outputs
        return outputs[f"stage{max_stage}"]
