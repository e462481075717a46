"""2D → 3D depth lifting with anatomical priors (counterpart of
hybrid_vit_cascade_tpu/models/depth_lifting.py). Used by the diffusion family.

X-ray features are NCHW here, (B, C, H, W) (the JAX package is channels-last);
the lifted volume is (B, C, D, H, W). The lifter's convs are flax ``nn.Conv``
in the JAX package, outside any Pallas kernel, so here they are ``F.conv2d``
/ ``F.conv3d`` (cuDNN), computing in ``dtype`` over fp32 parameters; every
GroupNorm follows flax's numerics (``group_norm_flax``). Module names are
flax's (``depth_{D}``, ``Conv_i``, ``GroupNorm_i``, ``prior_modulation``,
``fusion_{D}_a``, ``fusion_{D}_b``), so ``convert.flax_tree`` walks a JAX tree.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.conv3d import GroupNormNCDHW
from ..ops.resize import resize_trilinear
from .cnn_models import Conv3d
from .encoders import Conv2d

GN_GROUPS = 8  # the lifter's GroupNorms (flax group_norm(8))


class ResolutionDepthPriors:
    """Anatomical HU-depth bands per resolution (JAX ``depth_lifting.py:15-37``)."""

    PRIORS: Dict[int, Dict[str, Tuple[int, int]]] = {
        64: {"anterior": (0, 16), "mid": (16, 48), "posterior": (48, 64)},
        128: {"anterior": (0, 32), "mid": (32, 96), "posterior": (96, 128)},
        256: {"anterior": (0, 64), "mid": (64, 192), "posterior": (192, 256)},
        512: {"anterior": (0, 128), "mid": (128, 384), "posterior": (384, 512)},
        604: {"anterior": (0, 151), "mid": (151, 453), "posterior": (453, 604)},
    }

    @staticmethod
    def get_priors(depth_size: int) -> Dict[str, Tuple[int, int]]:
        if depth_size in ResolutionDepthPriors.PRIORS:
            return ResolutionDepthPriors.PRIORS[depth_size]
        ratio = depth_size / 604.0
        return {
            "anterior": (0, int(151 * ratio)),
            "mid": (int(151 * ratio), int(453 * ratio)),
            "posterior": (int(453 * ratio), depth_size),
        }


class CascadedDepthWeightNetwork(nn.Module):
    """Per-pixel softmax depth distribution modulated by a learned prior mask
    (JAX ``depth_lifting.py:40-66``): (B, C, H, W) → (B, D, H, W) in ``dtype``.
    Two 3×3 conv → GroupNorm(8) → SiLU stages and a 1×1 conv give the depth
    logits; their softmax, in fp32, times sigmoid(prior_modulation(x)) is
    renormalised with + 1e-8."""

    def __init__(self, max_depth: int, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv2d(channels, channels // 2, 3, padding=1, dtype=dtype)
        self.GroupNorm_0 = GroupNormNCDHW(GN_GROUPS, channels // 2, dtype, flax=True)
        self.Conv_1 = Conv2d(channels // 2, channels // 4, 3, padding=1, dtype=dtype)
        self.GroupNorm_1 = GroupNormNCDHW(GN_GROUPS, channels // 4, dtype, flax=True)
        self.Conv_2 = Conv2d(channels // 4, max_depth, 1, dtype=dtype)
        self.prior_modulation = Conv2d(channels, max_depth, 1, dtype=dtype)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.GroupNorm_0(self.Conv_0(feats)))
        h = F.silu(self.GroupNorm_1(self.Conv_1(h)))
        logits = self.Conv_2(h)
        prior = torch.sigmoid(self.prior_modulation(feats))
        w = torch.softmax(logits.float(), dim=1) * prior.float()
        return (w / (w.sum(dim=1, keepdim=True) + 1e-8)).to(self.dtype)


class CascadedDepthLifting(nn.Module):
    """Lift (B, C, H, W) X-ray features to a (B, C, D, H, W) volume by their
    outer product with the per-pixel depth distribution, fusing a previous
    stage's volume by concat → conv → GroupNorm → SiLU → conv when cascading
    (JAX ``depth_lifting.py:82-151``). The module serves one target depth D
    (the JAX module creates the parameters of the depth it is called at).

    ``prev`` (B, c, D', H', W') is resized to (D, H, W) (trilinear,
    align_corners=True) and, with c = 1, broadcast to C. Fusion runs when a
    prev is given, ``use_prev_stage`` is set and D > min(depth_sizes).

    ``lift_slabs`` > 1 (and dividing D) streams the fusion in depth slabs
    (``_fused_streamed``, JAX ``:153-237``): the (B, 2C, D, H, W) concat and
    the fusion's fp32 GroupNorm intermediates never exist at full depth. Its
    parameters and values are the dense path's."""

    def __init__(self, feature_dim: int, target_depth: int,
                 depth_sizes: Sequence[int] = (64, 128, 256), use_prev_stage: bool = True,
                 dtype: torch.dtype = torch.float32, lift_slabs: int = 0):
        super().__init__()
        D = target_depth
        self.dtype = dtype
        self.depth = D
        self.lift_slabs = lift_slabs
        self.can_fuse = use_prev_stage and D > min(depth_sizes)
        self.add_module(f"depth_{D}", CascadedDepthWeightNetwork(D, feature_dim, dtype))
        if self.can_fuse:
            self.add_module(f"fusion_{D}_a", Conv3d(2 * feature_dim, feature_dim, 3, dtype=dtype))
            self.GroupNorm_0 = GroupNormNCDHW(GN_GROUPS, feature_dim, dtype, flax=True)
            self.add_module(f"fusion_{D}_b", Conv3d(feature_dim, feature_dim, 3, dtype=dtype))

    def forward(self, feats: torch.Tensor,
                prev_stage_volume: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, C, H, W = feats.shape
        D = self.depth
        feats = feats.to(self.dtype)
        weights = getattr(self, f"depth_{D}")(feats)  # (B, D, H, W)
        if prev_stage_volume is None or not self.can_fuse:
            return feats[:, :, None] * weights[:, None]  # (B, C, D, H, W)
        prev = resize_trilinear(prev_stage_volume, (D, H, W), align_corners=True).to(self.dtype)
        if self.lift_slabs > 1 and D % self.lift_slabs == 0:
            return self._fused_streamed(feats, weights, prev)
        vol = feats[:, :, None] * weights[:, None]
        h = torch.cat([vol, prev.expand(B, C, D, H, W)], dim=1)
        h = F.silu(self.GroupNorm_0(getattr(self, f"fusion_{D}_a")(h)))
        return getattr(self, f"fusion_{D}_b")(h)

    def _conv(self, which: str, x: torch.Tensor) -> torch.Tensor:
        """fusion_{D}_{which} without padding along D: the output planes whose
        3-plane window lies inside x (the JAX path's SAME conv cropped by one
        plane at each end)."""
        conv = getattr(self, f"fusion_{self.depth}_{which}")
        dt = self.dtype
        return F.conv3d(x, conv.weight.to(dt), conv.bias.to(dt), padding=(0, 1, 1))

    def _fused_streamed(self, feats: torch.Tensor, weights: torch.Tensor,
                        prev: torch.Tensor) -> torch.Tensor:
        """Depth-slab streamed lift → concat → conv_a → GroupNorm → SiLU →
        conv_b. Pass 1 accumulates the global GroupNorm Σ and Σ² in fp32 from
        conv_a over a ±1 halo; pass 2 re-streams with a ±2 halo, normalises in
        fp32, applies scale and bias, casts, applies SiLU in the compute dtype,
        zeroes the rows outside the volume (conv_b sees zero padding there in
        the dense path) and runs conv_b. Each slab is a recompute region."""
        B, C, H, W = feats.shape
        D, S, G = self.depth, self.lift_slabs, GN_GROUPS
        ds = D // S
        F_ = getattr(self, f"fusion_{D}_a").out_channels
        gsz = F_ // G
        norm = self.GroupNorm_0

        def lift_extent(lo: int, hi: int) -> torch.Tensor:
            """The concat over planes [lo, hi), zero outside [0, D)."""
            lo_c, hi_c = max(lo, 0), min(hi, D)
            v = feats[:, :, None] * weights[:, None, lo_c:hi_c]
            p = prev[:, :, lo_c:hi_c]
            h = torch.cat([v, p.expand(B, C, *p.shape[2:])], dim=1)
            if lo_c - lo or hi - hi_c:
                h = F.pad(h, (0, 0, 0, 0, lo_c - lo, hi - hi_c))
            return h

        def slab_sums(j: int):
            d0 = j * ds
            hf = self._conv("a", lift_extent(d0 - 1, d0 + ds + 1)).float()
            hf = hf.reshape(B, G, -1)  # (B, G, gsz·ds·H·W)
            return hf.sum(dim=2), (hf * hf).sum(dim=2)

        def emit(j: int, mean: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
            d0 = j * ds
            h = self._conv("a", lift_extent(d0 - 2, d0 + ds + 2))  # (B, F, ds + 2, H, W)
            hf = h.float().reshape(B, G, gsz, ds + 2, H, W)
            hf = (hf - mean[:, :, None, None, None, None]) * inv[:, :, None, None, None, None]
            hf = hf.reshape(B, F_, ds + 2, H, W)
            hn = F.silu((hf * norm.weight[:, None, None, None]
                         + norm.bias[:, None, None, None]).to(self.dtype))
            if d0 == 0 or d0 + ds == D:
                keep = torch.ones(ds + 2, dtype=hn.dtype, device=hn.device)
                if d0 == 0:
                    keep[0] = 0
                if d0 + ds == D:
                    keep[-1] = 0
                hn = hn * keep[:, None, None]
            return self._conv("b", hn)  # (B, F, ds, H, W)

        recompute = torch.is_grad_enabled()
        s1 = feats.new_zeros((B, G), dtype=torch.float32)
        s2 = feats.new_zeros((B, G), dtype=torch.float32)
        for j in range(S):
            a, b = (checkpoint(slab_sums, j, use_reentrant=False) if recompute
                    else slab_sums(j))
            s1, s2 = s1 + a, s2 + b
        count = float(D * H * W * gsz)
        mean = s1 / count
        var = (s2 / count - mean * mean).clamp_min(0.0)
        inv = torch.rsqrt(var + 1e-5)
        outs = [checkpoint(emit, j, mean, inv, use_reentrant=False) if recompute
                else emit(j, mean, inv) for j in range(S)]
        return torch.cat(outs, dim=2)
