"""The CNN decoder family (counterpart of
hybrid_vit_cascade_tpu/models/cnn_models.py): coarse-to-fine learnable-seed
decoders with per-scale X-ray fusion.

A learnable low-resolution seed volume is upsampled stage by stage
(trilinear ×2, align_corners=False → 3×3×3 conv → GroupNorm → act →
ResidualDenseBlocks); at every scale a bilinear-resized copy of the 2D X-ray
feature map is broadcast along depth (optionally modulated by
1 + 0.3·sin(π·z/D)), concatenated and fused 1×1; multi-scale skips are
re-upsampled and fused before a conv refinement head.

These convs are flax ``nn.Conv`` in the JAX package, left to XLA, and none
reaches a Pallas kernel: here they are ``F.conv3d`` / ``F.conv2d`` (cuDNN).
Parameters are fp32, compute in ``dtype``; every GroupNorm follows flax's
numerics (``group_norm_flax``). Module names are flax's (``Conv_i``,
``GroupNorm_i``, ``ResidualDenseBlock_i`` and the JAX modules' explicit
names), so ``convert.flax_tree`` maps a JAX tree by walking it and
``shape_matched_transfer`` pairs the tensors the JAX function pairs.

The seed volume's edge is the JAX modules' (16, 32 and 16); nothing in a
forward fixes it but the ``initial_volume`` parameter, so a test on the CPU
replaces that parameter with a smaller one. Activations are NCDHW (a chip
measurement preferred it to ``channels_last_3d``, PERF.md §6).

With ``remat`` and ``train`` the upsample stages recompute in the backward
(``torch.utils.checkpoint``), as the JAX package wraps them in ``nn.remat``;
beyond it, every ResidualDenseBlock (in the stages and in the head) is a
recompute region of its own, so each stage RDB's forward runs three times
a step. On an 80 GB card the 128³ decoder's batch-2 step ran out of memory
with the stages alone recomputed and with the RDBs alone; nested it fits
(PERF.md §6). The 256³ decoders' top scale recomputes too, in a few regions
(the B200's last upsample stage with the fusion after it, each skip
projection, the concat with its 1×1 fusion, the conv head), so that no more
of its maps are held at once than one region makes. Recomputing changes no
value.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.conv3d import GroupNormNCDHW, group_norm_groups
from ..ops.resize import resize_bilinear, resize_trilinear
from .encoders import SimpleXrayEncoder, XRayEncoderB200
from .layers import Linear

_ACTS = {"gelu": F.gelu, "relu": F.relu}


class Conv3d(nn.Conv3d):
    """nn.Conv3d with padding k // 2, computing in ``dtype`` over fp32
    parameters (flax's ``dtype=`` rule)."""

    def __init__(self, in_ch: int, out_ch: int, k: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, k, padding=k // 2, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv3d(x.to(dt), self.weight.to(dt), b, padding=self.padding)


def _remat(module: nn.Module, x: torch.Tensor, remat: bool, *args) -> torch.Tensor:
    """module(x, *args), recomputed in the backward when ``remat`` and autograd
    records."""
    if remat and torch.is_grad_enabled():
        return checkpoint(module, x, *args, use_reentrant=False)
    return module(x, *args)


def _gn(groups: int, channels: int, dtype: torch.dtype) -> GroupNormNCDHW:
    return GroupNormNCDHW(groups, channels, dtype, flax=True)


def _upsample(x: torch.Tensor, scale: int, dtype: torch.dtype) -> torch.Tensor:
    """Trilinear ×scale (align_corners=False) in fp32, cast to ``dtype``."""
    size = tuple(scale * s for s in x.shape[2:])
    return resize_trilinear(x, size, align_corners=False).to(dtype)


class ResidualDenseBlock(nn.Module):
    """Dense-concat growth block with a 1×1 compression and a residual
    (JAX ``cnn_models.py:42``): layer i maps the concat of the input and the
    earlier layers' outputs to ``growth_rate`` channels."""

    def __init__(self, channels: int, growth_rate: int = 32, num_layers: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        g = group_norm_groups(8, growth_rate)
        for i in range(num_layers):
            self.add_module(f"Conv_{i}", Conv3d(channels + i * growth_rate, growth_rate, 3,
                                                dtype=dtype))
            self.add_module(f"GroupNorm_{i}", _gn(g, growth_rate, dtype))
        self.add_module(f"Conv_{num_layers}",
                        Conv3d(channels + num_layers * growth_rate, channels, 1, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for i in range(self.num_layers):
            h = getattr(self, f"Conv_{i}")(torch.cat(feats, 1))
            feats.append(F.gelu(getattr(self, f"GroupNorm_{i}")(h)))
        return x + getattr(self, f"Conv_{self.num_layers}")(torch.cat(feats, 1))


class CBAM(nn.Module):
    """Channel + spatial attention (JAX ``cnn_models.py:64``): a shared
    two-layer MLP over the channels' mean and max, then a 7³ conv over the
    [channel mean, channel max] map."""

    def __init__(self, channels: int, reduction: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Dense_0 = Linear(channels, channels // reduction, bias=False, dtype=dtype)
        self.Dense_1 = Linear(channels // reduction, channels, bias=False, dtype=dtype)
        self.Conv_0 = Conv3d(2, 1, 7, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, D, H, W)
        def mlp(v):
            return self.Dense_1(F.relu(self.Dense_0(v)))

        att = torch.sigmoid(mlp(x.mean(dim=(2, 3, 4))) + mlp(x.amax(dim=(2, 3, 4))))
        x = x * att[:, :, None, None, None]
        sp = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], 1)
        return x * torch.sigmoid(self.Conv_0(sp))


class UpConvStage(nn.Module):
    """Trilinear ×2 (align_corners=False) → 3×3×3 conv → GroupNorm → act →
    ResidualDenseBlocks (JAX ``cnn_models.py:86``); ``rdbs`` holds
    (growth_rate, num_layers) pairs."""

    def __init__(self, in_ch: int, features: int, groups: int, rdbs: Sequence[tuple] = (),
                 act: str = "gelu", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.act = _ACTS[act]
        self.Conv_0 = Conv3d(in_ch, features, 3, dtype=dtype)
        self.GroupNorm_0 = _gn(groups, features, dtype)
        self.n_rdb = len(rdbs)
        for i, (growth, layers) in enumerate(rdbs):
            self.add_module(f"ResidualDenseBlock_{i}",
                            ResidualDenseBlock(features, growth, layers, dtype))

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """remat: recompute each ResidualDenseBlock in the backward."""
        x = self.act(self.GroupNorm_0(self.Conv_0(_upsample(x, 2, self.dtype))))
        for i in range(self.n_rdb):
            x = _remat(getattr(self, f"ResidualDenseBlock_{i}"), x, remat)
        return x


class XrayFusion(nn.Module):
    """concat(voxel feats, broadcast X-ray feats) → 1×1 conv → GroupNorm →
    GELU (JAX ``cnn_models.py:111``); ``bare_conv`` (the B200 decoder) keeps
    only the conv."""

    def __init__(self, in_ch: int, features: int, bare_conv: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv3d(in_ch, features, 1, dtype=dtype)
        self.GroupNorm_0 = None if bare_conv else _gn(group_norm_groups(32, features),
                                                      features, dtype)

    def forward(self, voxel: torch.Tensor, xray_3d: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(torch.cat([voxel, xray_3d.to(voxel.dtype)], 1))
        return h if self.GroupNorm_0 is None else F.gelu(self.GroupNorm_0(h))


class SkipProj(nn.Module):
    """Trilinear ×scale upsample → k³ conv (→ GroupNorm → GELU when
    ``groups``) (JAX ``cnn_models.py:130``)."""

    def __init__(self, in_ch: int, scale: int, features: int, kernel: int = 3,
                 groups: int | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = scale
        self.dtype = dtype
        self.Conv_0 = Conv3d(in_ch, features, kernel, dtype=dtype)
        self.GroupNorm_0 = None if groups is None else _gn(groups, features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(_upsample(x, self.scale, self.dtype))
        return x if self.GroupNorm_0 is None else F.gelu(self.GroupNorm_0(x))


def depth_modulated_broadcast(xray_feats: torch.Tensor, size: int,
                              modulate: bool) -> torch.Tensor:
    """(B, C, H', W') → bilinear (align_corners=False) to size² → broadcast
    along depth to (B, C, size, size, size); with ``modulate`` scaled by
    1 + 0.3·sin(linspace(0, 1, size)·3.14159) along depth, in the features'
    dtype (JAX ``cnn_models.py:152``). Unmodulated, the result is an
    expanded view (torch.cat copies it once)."""
    f = resize_bilinear(xray_feats, (size, size), align_corners=False)
    f3d = f[:, :, None].expand(-1, -1, size, -1, -1)
    if not modulate:
        return f3d
    z = torch.linspace(0.0, 1.0, size, device=f.device)
    mod = (1.0 + 0.3 * torch.sin(z * 3.14159)).to(f.dtype)
    return f3d * mod[None, None, :, None, None]


class _Decoder(nn.Module):
    """What the three decoders share: the seed volume and remat of the
    upsample stages."""

    def __init__(self, seed_channels: int, seed_size: int, seed_std: float, dtype: torch.dtype,
                 remat: bool):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.initial_volume = nn.Parameter(
            seed_std * torch.randn(1, seed_channels, seed_size, seed_size, seed_size))

    def _seed(self, batch: int) -> torch.Tensor:
        return self.initial_volume.expand(batch, -1, -1, -1, -1).to(self.dtype)

    def _stage(self, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
        """Upsample stage ``name``: with remat in training one recompute
        region, each of its RDBs another."""
        remat = self.remat and train
        return _remat(getattr(self, name), x, remat, remat)

    def _rdb(self, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
        return _remat(getattr(self, name), x, self.remat and train)

    def _fuse(self, name: str, x: torch.Tensor, feats: torch.Tensor,
              modulate: bool) -> torch.Tensor:
        """XrayFusion ``name`` of x and the X-ray features broadcast to x's size."""
        xray = depth_modulated_broadcast(feats, x.shape[-1], modulate)
        return getattr(self, name)(x, xray)


class Direct128ModelH200(_Decoder):
    """16³ seed → 128³, 320 channels at the top, ``num_rdb`` RDBs there
    (JAX ``cnn_models.py:166``): xrays (B, 2, 1, S, S) → (B, 1, 128, 128, 128)."""

    def __init__(self, xray_feature_dim: int = 512, num_rdb: int = 5,
                 dtype: torch.dtype = torch.float32, remat: bool = True):
        super().__init__(1, 16, 0.02, dtype, remat)
        fd = xray_feature_dim
        self.xray_encoder = SimpleXrayEncoder(fd, dtype)
        self.enc_16_32 = UpConvStage(1, 64, 16, ((24, 4),), dtype=dtype)
        self.xray_fusion_32 = XrayFusion(64 + fd, 64, dtype=dtype)
        self.enc_32_64 = UpConvStage(64, 128, 32, ((32, 4),), dtype=dtype)
        self.xray_fusion_64 = XrayFusion(128 + fd, 128, dtype=dtype)
        self.enc_64_128 = UpConvStage(128, 320, 64, ((32, 4),) * num_rdb, dtype=dtype)
        self.xray_fusion_128 = XrayFusion(320 + fd, 320, dtype=dtype)
        self.skip_proj_32_to_128 = SkipProj(64, 4, 64, 3, 16, dtype)
        self.skip_proj_64_to_128 = SkipProj(128, 2, 128, 3, 32, dtype)
        self.Conv_0 = Conv3d(320 + 128 + 64, 320, 1, dtype=dtype)
        self.GroupNorm_0 = _gn(64, 320, dtype)
        self.ResidualDenseBlock_0 = ResidualDenseBlock(320, 32, 4, dtype)
        self.ResidualDenseBlock_1 = ResidualDenseBlock(320, 32, 4, dtype)
        cin = 320
        for i, (ch, g) in enumerate([(192, 48), (96, 24), (48, 12)], start=1):
            self.add_module(f"Conv_{i}", Conv3d(cin, ch, 3, dtype=dtype))
            self.add_module(f"GroupNorm_{i}", _gn(g, ch, dtype))
            cin = ch
        self.Conv_4 = Conv3d(48, 1, 1, dtype=dtype)

    def forward(self, xrays: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        feats = self.xray_encoder(xrays, train)
        x = self._seed(xrays.shape[0])
        x32f = self._fuse("xray_fusion_32", self._stage("enc_16_32", x, train), feats, True)
        x64f = self._fuse("xray_fusion_64", self._stage("enc_32_64", x32f, train), feats, True)
        x128f = self._fuse("xray_fusion_128", self._stage("enc_64_128", x64f, train), feats, True)
        h = torch.cat([x128f, self.skip_proj_64_to_128(x64f), self.skip_proj_32_to_128(x32f)], 1)
        h = F.gelu(self.GroupNorm_0(self.Conv_0(h)))
        h = self._rdb("ResidualDenseBlock_0", h, train)
        h = self._rdb("ResidualDenseBlock_1", h, train)
        for i in (1, 2, 3):
            h = F.gelu(getattr(self, f"GroupNorm_{i}")(getattr(self, f"Conv_{i}")(h)))
        return self.Conv_4(h)


class Direct256ModelH200(_Decoder):
    """32³ seed → 256³, 192 channels at the top, ``num_rdb`` RDBs there
    (JAX ``cnn_models.py:220``)."""

    def __init__(self, xray_feature_dim: int = 512, num_rdb: int = 3,
                 dtype: torch.dtype = torch.float32, remat: bool = True):
        super().__init__(1, 32, 0.02, dtype, remat)
        fd = xray_feature_dim
        self.xray_encoder = SimpleXrayEncoder(fd, dtype)
        self.enc_32_64 = UpConvStage(1, 64, 16, ((32, 4),), dtype=dtype)
        self.xray_fusion_64 = XrayFusion(64 + fd, 64, dtype=dtype)
        self.enc_64_128 = UpConvStage(64, 128, 32, ((32, 4),), dtype=dtype)
        self.xray_fusion_128 = XrayFusion(128 + fd, 128, dtype=dtype)
        self.enc_128_256 = UpConvStage(128, 192, 48, ((24, 4),) * num_rdb, dtype=dtype)
        self.xray_fusion_256 = XrayFusion(192 + fd, 192, dtype=dtype)
        self.skip_proj_64_to_256 = SkipProj(64, 4, 64, 3, 16, dtype)
        self.skip_proj_128_to_256 = SkipProj(128, 2, 128, 3, 32, dtype)
        self.Conv_0 = Conv3d(192 + 128 + 64, 192, 1, dtype=dtype)
        self.GroupNorm_0 = _gn(48, 192, dtype)
        self.ResidualDenseBlock_0 = ResidualDenseBlock(192, 24, 4, dtype)
        cin = 192
        for i, (ch, g) in enumerate([(128, 32), (64, 16)], start=1):
            self.add_module(f"Conv_{i}", Conv3d(cin, ch, 3, dtype=dtype))
            self.add_module(f"GroupNorm_{i}", _gn(g, ch, dtype))
            cin = ch
        self.Conv_3 = Conv3d(64, 1, 1, dtype=dtype)

    def forward(self, xrays: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        feats = self.xray_encoder(xrays, train)
        x = self._seed(xrays.shape[0])
        x64f = self._fuse("xray_fusion_64", self._stage("enc_32_64", x, train), feats, True)
        x128f = self._fuse("xray_fusion_128", self._stage("enc_64_128", x64f, train), feats, True)
        remat = self.remat and train
        x256f = _remat(self._top, self._stage("enc_128_256", x128f, train), remat, feats)
        skips = [_remat(self.skip_proj_128_to_256, x128f, remat),
                 _remat(self.skip_proj_64_to_256, x64f, remat)]
        h = _remat(self._concat_fuse, x256f, remat, *skips)
        h = self._rdb("ResidualDenseBlock_0", h, train)
        return _remat(self._head, h, remat)

    def _top(self, x: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
        return self._fuse("xray_fusion_256", x, feats, True)

    def _concat_fuse(self, x: torch.Tensor, *skips: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.GroupNorm_0(self.Conv_0(torch.cat([x, *skips], 1))))

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        for i in (1, 2):
            h = F.gelu(getattr(self, f"GroupNorm_{i}")(getattr(self, f"Conv_{i}")(h)))
        return self.Conv_3(h)


class Direct256ModelB200(_Decoder):
    """16³ × 16-channel seed → 256³ with CBAM at 128³, ReLU, bare 1×1
    fusions, no depth modulation, no RDB at 256³ (JAX ``cnn_models.py:273``)."""

    def __init__(self, dtype: torch.dtype = torch.float32, remat: bool = True):
        super().__init__(16, 16, 0.01, dtype, remat)
        self.xray_encoder = XRayEncoderB200(dtype)
        self.enc_16_32 = UpConvStage(16, 32, 8, ((16, 4),), act="relu", dtype=dtype)
        self.xray_fusion_32 = XrayFusion(32 + 128, 32, bare_conv=True, dtype=dtype)
        self.enc_32_64 = UpConvStage(32, 64, 8, ((24, 4),), act="relu", dtype=dtype)
        self.xray_fusion_64 = XrayFusion(64 + 128, 64, bare_conv=True, dtype=dtype)
        self.enc_64_128 = UpConvStage(64, 128, 16, ((16, 3), (16, 3)), act="relu", dtype=dtype)
        self.xray_fusion_128 = XrayFusion(128 + 128, 128, bare_conv=True, dtype=dtype)
        self.cbam_128 = CBAM(128, 16, dtype)
        self.enc_128_256_a = UpConvStage(128, 128, 16, act="relu", dtype=dtype)
        self.Conv_0 = Conv3d(128, 128, 3, dtype=dtype)
        self.GroupNorm_0 = _gn(16, 128, dtype)
        self.xray_fusion_256 = XrayFusion(128 + 128, 128, bare_conv=True, dtype=dtype)
        self.skip_proj_32_to_256 = SkipProj(32, 8, 64, 1, None, dtype)
        self.skip_proj_64_to_256 = SkipProj(64, 4, 64, 1, None, dtype)
        self.skip_proj_128_to_256 = SkipProj(128, 2, 64, 1, None, dtype)
        self.Conv_1 = Conv3d(128 + 3 * 64, 128, 1, dtype=dtype)
        self.GroupNorm_1 = _gn(16, 128, dtype)
        cin = 128
        for i, (ch, g) in enumerate([(64, 8), (32, 8), (16, 4)], start=2):
            self.add_module(f"Conv_{i}", Conv3d(cin, ch, 3, dtype=dtype))
            self.add_module(f"GroupNorm_{i}", _gn(g, ch, dtype))
            cin = ch
        self.Conv_5 = Conv3d(16, 1, 1, dtype=dtype)

    def forward(self, xrays: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        feats = self.xray_encoder(xrays, train)
        x = self._seed(xrays.shape[0])
        skip32 = self._fuse("xray_fusion_32", self._stage("enc_16_32", x, train), feats, False)
        skip64 = self._fuse("xray_fusion_64", self._stage("enc_32_64", skip32, train), feats, False)
        skip128 = self.cbam_128(
            self._fuse("xray_fusion_128", self._stage("enc_64_128", skip64, train), feats, False))
        remat = self.remat and train
        x = _remat(self._top, skip128, remat, feats)
        skips = [_remat(getattr(self, f"skip_proj_{n}_to_256"), t, remat)
                 for n, t in ((32, skip32), (64, skip64), (128, skip128))]
        h = _remat(self._concat_fuse, x, remat, *skips)
        return _remat(self._head, h, remat)

    def _top(self, skip128: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
        """enc_128_256_a → Conv_0 → GroupNorm_0 → ReLU → xray_fusion_256."""
        x = F.relu(self.GroupNorm_0(self.Conv_0(self.enc_128_256_a(skip128))))
        return self._fuse("xray_fusion_256", x, feats, False)

    def _concat_fuse(self, x: torch.Tensor, *skips: torch.Tensor) -> torch.Tensor:
        return F.relu(self.GroupNorm_1(self.Conv_1(torch.cat([x, *skips], 1))))

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        for i in (2, 3, 4):
            h = F.relu(getattr(self, f"GroupNorm_{i}")(getattr(self, f"Conv_{i}")(h)))
        return self.Conv_5(h)
