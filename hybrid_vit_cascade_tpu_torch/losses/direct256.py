"""The CNN decoders' seven-component loss (counterpart of
hybrid_vit_cascade_tpu/losses/direct256.py).

Weights: L1 1.0, SSIM 0.5, focal frequency 0.2, perceptual pyramid 0.15,
TV 0.02, style 0.1, anatomical attention 0.3. Each component is reduced in
fp32 and clamped; a non-finite component value is zeroed where the JAX
package zeroes it, and a non-finite total falls back to L1 + SSIM + TV.

The perceptual, style and attention feature nets are frozen, fp32 3D conv
stacks (``F.conv3d``, a conv the JAX package leaves to XLA) with flax's
GroupNorm numerics. Their weights are, in order of preference, the JAX
nets' variables converted by ``convert.direct256_nets`` (``weights=``), or
by default drawn from a seeded ``torch.Generator`` with flax ``nn.Conv``'s
defaults (``lecun_normal`` kernels, zero biases): the same kind of frozen
random features, not JAX's draws (a flax seed cannot be replayed in torch).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from ..ops.conv3d import group_norm_flax
from ..ops.fft import fft_magnitude_3d, half_spectrum_multiplicity, rfft_magnitude_3d
from ..ops.resize import resize_trilinear
from .multiscale import l1_loss, lecun_normal_, ssim_loss, total_variation_loss

# (out channels, kernel, GroupNorm groups or None) of each net's convs, from
# one input channel; the last conv of "style" has no norm and no activation,
# "attention" ends in a 1×1 conv and a sigmoid
NETS = {
    "pyramid": ((32, 3, 8), (64, 3, 16), (128, 3, 32)),
    "style": ((32, 3, 8), (64, 3, 16), (64, 3, None)),
    "attention": ((16, 3, 4), (32, 3, 8), (1, 1, None)),
}


def _finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def focal_frequency_loss(pred: torch.Tensor, target: torch.Tensor,
                         alpha: float = 1.0) -> torch.Tensor:
    """FFT-magnitude squared error, focally reweighted by the error over its
    per-volume sum; fp32, clamped to [0, 100]. Even sizes run on the rfft half
    spectrum with per-bin multiplicities, odd sizes on the full one."""
    shape = tuple(pred.shape[-3:])
    if all(s % 2 == 0 for s in shape):
        pm, tm = rfft_magnitude_3d(pred), rfft_magnitude_3d(target)
        mult = half_spectrum_multiplicity(shape, pred.device)
        dist = (pm - tm) ** 2
        norm = (dist * mult).sum(dim=(-3, -2, -1), keepdim=True)
        focal = torch.pow(dist / (norm + 1e-8), alpha)
        loss = (focal * dist * mult).sum() / pred.numel()
    else:
        pm, tm = fft_magnitude_3d(pred), fft_magnitude_3d(target)
        dist = (pm - tm) ** 2
        norm = dist.sum(dim=(-3, -2, -1), keepdim=True)
        loss = (torch.pow(dist / (norm + 1e-8), alpha) * dist).mean()
    return _finite_or_zero(loss.clamp(0.0, 100.0))


def seeded_nets(seed: int = 4242) -> Dict[str, Dict[str, torch.Tensor]]:
    """The three nets' weights from one seeded torch.Generator, in NETS
    order: flax nn.Conv's defaults, GroupNorm scales 1 and biases 0."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, convs in NETS.items():
        sd, cin, n_gn = {}, 1, 0
        for i, (cout, k, groups) in enumerate(convs):
            sd[f"Conv_{i}.weight"] = lecun_normal_(torch.empty(cout, cin, k, k, k), g)
            sd[f"Conv_{i}.bias"] = torch.zeros(cout)
            if groups is not None:
                sd[f"GroupNorm_{n_gn}.weight"] = torch.ones(cout)
                sd[f"GroupNorm_{n_gn}.bias"] = torch.zeros(cout)
                n_gn += 1
            cin = cout
        out[name] = sd
    return out


def feature_net(name: str, weights: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Net ``name`` on x (B, 1, D, H, W) in fp32: conv → GroupNorm → GELU per
    NETS entry with groups, a bare conv otherwise; the attention net's
    output through a sigmoid."""
    x = x.float()
    n_gn = 0
    for i, (_, k, groups) in enumerate(NETS[name]):
        x = F.conv3d(x, weights[f"Conv_{i}.weight"], weights[f"Conv_{i}.bias"], padding=k // 2)
        if groups is not None:
            x = F.gelu(group_norm_flax(x, weights[f"GroupNorm_{n_gn}.weight"],
                                       weights[f"GroupNorm_{n_gn}.bias"], groups, torch.float32))
            n_gn += 1
    return torch.sigmoid(x) if name == "attention" else x


class Direct256Loss:
    """Resolution-agnostic seven-component loss; returns the JAX package's
    keys. ``weights``: {"pyramid", "style", "attention"} state dicts (see the
    module docstring), else the nets are drawn from ``seed``."""

    def __init__(self, l1_weight: float = 1.0, ssim_weight: float = 0.5,
                 focal_freq_weight: float = 0.2, perceptual_pyramid_weight: float = 0.15,
                 tv_weight: float = 0.02, style_weight: float = 0.1,
                 anatomical_weight: float = 0.3,
                 weights: Optional[Mapping[str, Mapping[str, torch.Tensor]]] = None,
                 seed: int = 4242):
        self.w = dict(l1=l1_weight, ssim=ssim_weight, focal=focal_freq_weight,
                      pyramid=perceptual_pyramid_weight, tv=tv_weight, style=style_weight,
                      anatomical=anatomical_weight)
        nets = seeded_nets(seed) if weights is None else weights
        self._nets = {n: {k: v.detach().float() for k, v in sd.items()} for n, sd in nets.items()}

    def _net(self, name: str, x: torch.Tensor) -> torch.Tensor:
        sd = self._nets[name]
        if next(iter(sd.values())).device != x.device:
            sd = self._nets[name] = {k: v.to(x.device) for k, v in sd.items()}
        return feature_net(name, sd, x)

    def perceptual_pyramid(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """L1 of the pyramid net's features at scales 1, 0.5 and 0.25
        (trilinear, align_corners=False), each clamped to [0, 100]."""
        total = 0.0
        for scale in (1.0, 0.5, 0.25):
            p, t = pred, target
            if scale != 1.0:
                size = tuple(int(s * scale) for s in pred.shape[-3:])
                p = resize_trilinear(pred, size, align_corners=False)
                t = resize_trilinear(target, size, align_corners=False)
            diff = (self._net("pyramid", p) - self._net("pyramid", t)).abs().mean()
            total = total + _finite_or_zero(diff).clamp(0.0, 100.0)
        return _finite_or_zero(total / 3.0)

    def style3d(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """MSE of the style net's Gram matrices, each over N·C and clamped to
        ±1e3."""

        def gram(feat):  # (B, C, D, H, W)
            flat = feat.flatten(2)  # (B, C, N)
            g = torch.bmm(flat, flat.transpose(1, 2))
            return (g / max(1.0, float(flat.shape[2] * flat.shape[1]))).clamp(-1e3, 1e3)

        loss = ((gram(self._net("style", pred)) - gram(self._net("style", target))) ** 2).mean()
        return _finite_or_zero(loss.clamp(0.0, 100.0))

    def anatomical_attention(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """0.7·attention-weighted L1 + 0.3·uniform L1; the attention net reads
        the target's gradient magnitude, min-max normalised (0.5 where flat),
        without a gradient."""
        t = target.float()
        gd = F.pad((t[..., 1:, :, :] - t[..., :-1, :, :]).abs(), (0, 0, 0, 0, 0, 1))
        gh = F.pad((t[..., :, 1:, :] - t[..., :, :-1, :]).abs(), (0, 0, 0, 1, 0, 0))
        gw = F.pad((t[..., :, :, 1:] - t[..., :, :, :-1]).abs(), (0, 1, 0, 0, 0, 0))
        imp = (gd + gh + gw) / 3.0
        lo, hi = imp.min(), imp.max()
        rng = hi - lo
        imp = torch.where(rng > 1e-6, (imp - lo) / (rng + 1e-8), torch.full_like(imp, 0.5))
        attention = self._net("attention", imp.detach())
        weighted = (attention * (pred.float() - t).abs()).mean()
        uniform = l1_loss(pred, target)
        return _finite_or_zero(0.7 * weighted.clamp(0.0, 100.0) + 0.3 * uniform.clamp(0.0, 100.0))

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> Dict[str, torch.Tensor]:
        l1 = l1_loss(pred, target).clamp(0.0, 100.0)
        ssim = ssim_loss(pred, target).clamp(0.0, 100.0)
        focal = focal_frequency_loss(pred, target)
        pyramid = self.perceptual_pyramid(pred, target)
        tv = total_variation_loss(pred, target).clamp(0.0, 100.0)
        style = self.style3d(pred, target)
        anatomical = self.anatomical_attention(pred, target)
        w = self.w
        total = (w["l1"] * l1 + w["ssim"] * ssim + w["focal"] * focal + w["pyramid"] * pyramid
                 + w["tv"] * tv + w["style"] * style + w["anatomical"] * anatomical)
        total = torch.where(torch.isfinite(total), total, l1 + ssim + tv)
        return {"total_loss": total, "l1_loss": l1, "ssim_loss": ssim, "focal_freq_loss": focal,
                "perceptual_pyramid_loss": pyramid, "tv_loss": tv, "style_loss": style,
                "anatomical_loss": anatomical}


def get_loss_summary_string(loss_dict: Mapping[str, torch.Tensor]) -> str:
    """One log line of a Direct256Loss dict."""
    f = lambda k: float(loss_dict[k])  # noqa: E731
    return (f"Loss: {f('total_loss'):.4f} | L1: {f('l1_loss'):.4f} | "
            f"SSIM: {f('ssim_loss'):.4f} | FocalFreq: {f('focal_freq_loss'):.4f} | "
            f"Perceptual: {f('perceptual_pyramid_loss'):.4f} | TV: {f('tv_loss'):.4f} | "
            f"Style: {f('style_loss'):.4f} | Anatomical: {f('anatomical_loss'):.4f}")
