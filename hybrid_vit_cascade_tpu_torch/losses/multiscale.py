"""Frequency-aware multi-scale loss (counterpart of
hybrid_vit_cascade_tpu/losses/multiscale.py).

Stage 1: L1 + 0.5·SSIM.
Stage 2: + 0.1·perceptual + 0.02·TV + 0.05·FFT-frequency.
Stage 3: + 0.1·perceptual + 0.03·TV + 0.07·FFT + 0.3·DRR reprojection.

Every term is reduced in fp32. The perceptual loss runs the VGG16 conv prefix
(relu1_2, relu2_2, relu3_3 taps) on the three mid orthogonal slices with
frozen filters through ``F.conv2d`` — a 2D conv the JAX package leaves to
XLA. Its filters are, in order of preference: converted VGG16 weights read
from the ``.npz`` that ``hybrid_vit_cascade_tpu/losses/vgg_weights.py``
writes (numpy only); a dict of tensors (``convert.vgg16`` of the JAX
variables, which the tests use to match JAX's seed-1234 filters); or, by
default, filters drawn from a seeded ``torch.Generator`` with flax's
``lecun_normal`` distribution. The default is not JAX's filters (a flax seed
cannot be replayed in torch), only the same kind of frozen random features.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.drr import drr_mean_projection
from ..ops.fft import (
    fft_magnitude_3d,
    half_spectrum_multiplicity,
    high_freq_mask,
    high_freq_mask_half,
    rfft_magnitude_3d,
)
from ..ops.ssim import ssim3d
from ..parallel.mesh import all_reduce_mean, ambient_group


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred.float() - target.float()).abs().mean()


def ssim_loss(pred: torch.Tensor, target: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    return 1.0 - ssim3d(pred, target, window_size)


def total_variation_loss(pred: torch.Tensor, target: Optional[torch.Tensor] = None,
                         eps: float = 1e-8) -> torch.Tensor:
    """Anisotropic sqrt(ε)-smoothed TV clamped to [0, 100]; with a target, the
    L1 between the two scalar TVs. Under a data group (``parallel.mesh``)
    the means are the global batch's, so the term is the one-process term."""
    group = ambient_group()

    def tv(v):
        v = v.float()
        dd = (v[..., 1:, :, :] - v[..., :-1, :, :]).abs()
        dh = (v[..., :, 1:, :] - v[..., :, :-1, :]).abs()
        dw = (v[..., :, :, 1:] - v[..., :, :, :-1]).abs()
        means = [torch.sqrt(d ** 2 + eps).mean() for d in (dd, dh, dw)]
        if group is not None and group.synced:
            means = all_reduce_mean(torch.stack(means), group, differentiable=True).unbind()
        t = (means[0] + means[1] + means[2]) / 3.0
        return t.clamp(0.0, 100.0)

    tv_pred = tv(pred)
    if target is None:
        return tv_pred
    return (tv_pred - tv(target)).abs()


def frequency_loss(pred: torch.Tensor, target: torch.Tensor,
                   high_freq_weight: float = 2.0) -> torch.Tensor:
    """FFT-magnitude L1 with high_freq_weight on radii > min/4; means over all
    elements with the complementary region zeroed. Even sizes run on the rfft
    half spectrum with per-bin multiplicities, odd sizes on the full one."""
    shape = tuple(pred.shape[-3:])
    n_full = pred.numel()
    dev = pred.device
    if all(s % 2 == 0 for s in shape):
        pm, tm = rfft_magnitude_3d(pred), rfft_magnitude_3d(target)
        mask = high_freq_mask_half(shape, dev)
        diff = (pm - tm).abs() * half_spectrum_multiplicity(shape, dev)
        low = (diff * (1.0 - mask)).sum() / n_full
        high = (diff * mask).sum() / n_full
    else:
        pm, tm = fft_magnitude_3d(pred), fft_magnitude_3d(target)
        mask = high_freq_mask(shape, dev)
        low = (pm * (1.0 - mask) - tm * (1.0 - mask)).abs().mean()
        high = (pm * mask - tm * mask).abs().mean()
    return low + high_freq_weight * high


def drr_reprojection_loss(pred: torch.Tensor, input_xrays: torch.Tensor,
                          img_size: int = 512) -> torch.Tensor:
    """Mean-projection DRR L1 against both input X-rays; pred (B, 1, D, H, W),
    input_xrays (B, 2, 1, S, S)."""
    vol = pred[:, 0]
    drr_ap = drr_mean_projection(vol, "ap", img_size)
    drr_lat = drr_mean_projection(vol, "lateral", img_size)
    xray_ap = input_xrays[:, 0, 0].float()
    xray_lat = input_xrays[:, 1, 0].float()
    return ((drr_ap - xray_ap).abs().mean() + (drr_lat - xray_lat).abs().mean()) / 2.0


# (in, out) channels of the seven VGG16 convs through conv3_3, and the conv
# after which a tap (relu1_2, relu2_2, relu3_3) is taken; a 2×2 max pool
# follows conv1_2 and conv2_2.
VGG_CONVS = ((3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256), (256, 256))
_TAPS = (1, 3, 6)
_POOL_AFTER = (1, 3)


def lecun_normal_(w: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """flax nn.Conv's default kernel initialiser, drawn from ``g`` into the
    (O, I, k…) tensor ``w``: truncated normal, std √(1/fan_in)/0.8796 cut at
    ±2σ."""
    std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
    return torch.nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=g)


def seeded_vgg16(seed: int = 1234) -> Dict[str, torch.Tensor]:
    """VGG16-prefix filters from a seeded torch.Generator: flax nn.Conv's
    defaults (``lecun_normal_`` kernels, zero bias)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, (cin, cout) in enumerate(VGG_CONVS):
        w = lecun_normal_(torch.empty(cout, cin, 3, 3), g)
        out[f"Conv_{i}.weight"] = w
        out[f"Conv_{i}.bias"] = torch.zeros(cout)
    return out


def load_vgg16_npz(path: str) -> Dict[str, torch.Tensor]:
    """Read the ``.npz`` of ``losses/vgg_weights.py:save_vgg16_variables``
    (keys ``Conv_i.kernel`` (kh, kw, in, out) and ``Conv_i.bias``) into the
    port's ``Conv_i.weight`` (out, in, kh, kw) / ``Conv_i.bias``, with numpy."""
    out = {}
    with np.load(path) as z:
        for key in z.files:
            conv, name = key.rsplit(".", 1)
            a = np.asarray(z[key], np.float32)
            if name == "kernel":
                out[f"{conv}.weight"] = torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1)))
            else:
                out[f"{conv}.bias"] = torch.from_numpy(a)
    missing = {f"Conv_{i}.{n}" for i in range(len(VGG_CONVS)) for n in ("weight", "bias")} - set(out)
    if missing:
        raise ValueError(f"{path} is missing converted layers: {sorted(missing)}")
    return out


def vgg16_features(x: torch.Tensor, weights: Mapping[str, torch.Tensor]) -> list:
    """x (N, 3, H, W) fp32 → [relu1_2, relu2_2, relu3_3]."""
    taps = []
    for i in range(len(VGG_CONVS)):
        x = F.relu(F.conv2d(x, weights[f"Conv_{i}.weight"], weights[f"Conv_{i}.bias"], padding=1))
        if i in _TAPS:
            taps.append(x)
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, 2, stride=2)
    return taps


class TriPlanarPerceptualLoss:
    """2D perceptual loss on the three mid orthogonal slices, VGG filters
    frozen (see the module docstring for where they come from)."""

    def __init__(self, weights: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 1234):
        w = seeded_vgg16(seed) if weights is None else weights
        self._weights = {k: v.detach().float() for k, v in w.items()}
        self.layer_weights = (1.0, 1.0, 1.0)

    def _on(self, device) -> Dict[str, torch.Tensor]:
        if next(iter(self._weights.values())).device != device:
            self._weights = {k: v.to(device) for k, v in self._weights.items()}
        return self._weights

    def __call__(self, pred_volume: torch.Tensor, target_volume: torch.Tensor) -> torch.Tensor:
        _, _, D, H, W = pred_volume.shape
        weights = self._on(pred_volume.device)
        md, mh, mw = D // 2, H // 2, W // 2
        pairs = [
            (pred_volume[:, :, md], target_volume[:, :, md]),              # axial (B, 1, H, W)
            (pred_volume[:, :, :, mh], target_volume[:, :, :, mh]),        # sagittal (B, 1, D, W)
            (pred_volume[:, :, :, :, mw], target_volume[:, :, :, :, mw]),  # coronal (B, 1, D, H)
        ]
        total = 0.0
        for p, t in pairs:
            p = ((p.float() + 1.0) / 2.0).repeat(1, 3, 1, 1)
            t = ((t.float() + 1.0) / 2.0).repeat(1, 3, 1, 1)
            for a, b, lw in zip(vgg16_features(p, weights), vgg16_features(t, weights),
                                self.layer_weights):
                total = total + lw * (a - b).abs().mean()
        return total / 3.0


_DEFAULT_WEIGHTS = {
    "stage1": {"l1": 1.0, "ssim": 0.5},
    "stage2": {"l1": 1.0, "ssim": 0.5, "vgg": 0.1, "tv": 0.02, "freq": 0.05},
    "stage3": {"l1": 1.0, "ssim": 0.5, "vgg": 0.1, "tv": 0.03, "freq": 0.07, "drr": 0.3},
}


class MultiScaleLoss:
    """Per-stage loss dispatcher; returns the JAX package's loss-dict keys."""

    def __init__(self, config: Optional[Dict] = None,
                 perceptual: Optional[TriPlanarPerceptualLoss] = None,
                 vgg_weights: Optional[str] = None):
        cfg = dict(_DEFAULT_WEIGHTS)
        if config:
            for k, v in config.items():
                cfg[k] = {**cfg.get(k, {}), **v}
        self.weights = cfg
        if perceptual is None and vgg_weights:
            perceptual = TriPlanarPerceptualLoss(weights=load_vgg16_npz(vgg_weights))
        self.perceptual = perceptual or TriPlanarPerceptualLoss()

    def __call__(self, pred: torch.Tensor, target: torch.Tensor, stage: int = 1,
                 input_xrays: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        w = self.weights[f"stage{stage}"]
        out: Dict[str, torch.Tensor] = {}
        out["l1_loss"] = l1_loss(pred, target)
        out["ssim_loss"] = ssim_loss(pred, target)
        total = w["l1"] * out["l1_loss"] + w["ssim"] * out["ssim_loss"]
        if stage >= 2:
            out["vgg_loss"] = self.perceptual(pred, target)
            out["tv_loss"] = total_variation_loss(pred, target)
            out["freq_loss"] = frequency_loss(pred, target)
            total = (total + w["vgg"] * out["vgg_loss"] + w["tv"] * out["tv_loss"]
                     + w["freq"] * out["freq_loss"])
        if stage >= 3 and input_xrays is not None:
            out["drr_loss"] = drr_reprojection_loss(pred, input_xrays, img_size=input_xrays.shape[-1])
            total = total + w["drr"] * out["drr_loss"]
        out["total_loss"] = total
        return out
