"""Feature-map extraction and accuracy metrics (counterpart of
hybrid_vit_cascade_tpu/losses/feature_metrics.py). Volumes are NCDHW.

The JAX module's nets are flax ``nn.Conv`` stacks with frozen random
filters from a seeded PRNG key; flax's initialisers cannot be reproduced in
torch, so by default the port draws its filters from a seeded
``torch.Generator`` with the same initialisers (``seeded_net``): the same
kind of net, not JAX's filters. ``convert.diagnostic_nets`` turns the JAX
variables into the state dicts that ``weights=`` takes, and with those the two
packages compute the same metrics. The convs are ``F.conv3d`` / ``F.conv2d``
(XLA convs in the JAX package, not a TPU kernel).

LPIPS3D computes the LPIPS *form* — unit-normalised deep features, squared
differences averaged over space and layers, on up to ``LPIPS_SLICES``
evenly spaced slices per anatomical axis — over those frozen random
features, as the JAX module does (no pretrained AlexNet offline).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv3d import GroupNormNCDHW
from ..ops.pool import box_filter_same, max_pool_nd
from .multiscale import lecun_normal_

FEATURE_DIMS = (32, 64, 128, 256)  # MultiLevelFeatureExtractor's levels
EXTRACTOR_SEED, LPIPS_SEED = 99, 77
LPIPS_SLICES = 16  # slices per anatomical axis, at most


def seeded_net(net: nn.Module, seed: int) -> nn.Module:
    """flax nn.Conv's default initialisers for every Conv2d / Conv3d of
    ``net``, in module order, from one generator seeded with ``seed``:
    ``lecun_normal_`` kernels, zero biases; norms keep unit scale and zero
    bias. Frozen: no parameter requires a gradient."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d)):
                lecun_normal_(m.weight, g)
                m.bias.zero_()
    return net.requires_grad_(False)


def _frozen(net: nn.Module, seed: int, weights: Optional[Mapping[str, torch.Tensor]]) -> nn.Module:
    if weights is None:
        return seeded_net(net, seed).eval()
    net.load_state_dict(weights, strict=True)
    return net.requires_grad_(False).eval()


def _on(net: nn.Module, x: torch.Tensor) -> nn.Module:
    """``net`` moved to x's device (a no-op once there)."""
    return net.to(x.device)


class MultiLevelFeatureExtractor(nn.Module):
    """4-level 3D conv encoder (``FEATURE_DIMS``), stride 2 after level 0;
    each level conv → GroupNorm(8) → ReLU twice (flax GroupNorm numerics, eps
    1e-5). Input (B, 1, D, H, W) fp32 → {"level_i": (B, C_i, d, h, w)}."""

    def __init__(self):
        super().__init__()
        self.convs, self.norms = nn.ModuleList(), nn.ModuleList()
        cin = 1
        for i, dim in enumerate(FEATURE_DIMS):
            self.convs.append(nn.Conv3d(cin, dim, 3, stride=2 if i > 0 else 1, padding=1))
            self.norms.append(GroupNormNCDHW(8, dim, flax=True))
            self.convs.append(nn.Conv3d(dim, dim, 3, padding=1))
            self.norms.append(GroupNormNCDHW(8, dim, flax=True))
            cin = dim

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = {}
        for i in range(len(self.convs) // 2):
            for j in (2 * i, 2 * i + 1):
                x = F.relu(self.norms[j](self.convs[j](x)))
            feats[f"level_{i}"] = x
        return feats


def _feature_cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    an = a / (a.norm(dim=1, keepdim=True) + 1e-12)
    bn = b / (b.norm(dim=1, keepdim=True) + 1e-12)
    return (an * bn).sum(dim=1).mean()


def _feature_correlation(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    B, C = a.shape[:2]
    ac = a.reshape(B, C, -1)
    bc = b.reshape(B, C, -1)
    ac = ac - ac.mean(dim=2, keepdim=True)
    bc = bc - bc.mean(dim=2, keepdim=True)
    num = (ac * bc).sum(dim=2)
    den = torch.sqrt((ac ** 2).sum(dim=2) * (bc ** 2).sum(dim=2) + 1e-8)
    return (num / den).mean()


def _feature_ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SSIM of feature maps with a 3³ box window."""
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    sp = (2, 3, 4)
    mu_a = box_filter_same(a, 3, sp)
    mu_b = box_filter_same(b, 3, sp)
    sa = box_filter_same(a * a, 3, sp) - mu_a ** 2
    sb = box_filter_same(b * b, 3, sp) - mu_b ** 2
    sab = box_filter_same(a * b, 3, sp) - mu_a * mu_b
    ssim = ((2 * mu_a * mu_b + C1) * (2 * sab + C2)) / (
        (mu_a ** 2 + mu_b ** 2 + C1) * (sa + sb + C2))
    return ssim.mean()


def _gram(feat: torch.Tensor) -> torch.Tensor:
    B, C = feat.shape[:2]
    flat = feat.reshape(B, C, -1)
    return torch.einsum("bcn,bdn->bcd", flat, flat) / float(flat.shape[2] * C)


class _Slice2DFeatureNet(nn.Module):
    """AlexNet-ish 2D stack for the LPIPS form: convs (64, k7, s2), (128, k5,
    s2), (256, k3), (256, k3), each → ReLU → a tap; a 2×2 max pool after the
    third tap only. (N, 3, H, W) → four taps."""

    _LAYERS = ((3, 64, 7, 2), (64, 128, 5, 2), (128, 256, 3, 1), (256, 256, 3, 1))

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(nn.Conv2d(cin, cout, k, stride=s, padding=k // 2)
                                   for cin, cout, k, s in self._LAYERS)

    def forward(self, x: torch.Tensor) -> list:
        taps = []
        for i, conv in enumerate(self.convs):
            x = F.relu(conv(x))
            taps.append(x)
            if i == 2:
                x = max_pool_nd(x, 2, stride=2)
        return taps


class LPIPS3D:
    """Slice-sampled perceptual distance over three anatomical axes; see the
    module docstring for the filters. weights: a ``_Slice2DFeatureNet`` state
    dict (``convert.diagnostic_nets``), else seeded from ``LPIPS_SEED``."""

    def __init__(self, weights: Optional[Mapping[str, torch.Tensor]] = None):
        self._net = _frozen(_Slice2DFeatureNet(), LPIPS_SEED, weights)

    def _lpips_2d(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        net = _on(self._net, a)
        fa, fb = net(a), net(b)
        total = 0.0
        for x, y in zip(fa, fb):
            xn = x / (x.norm(dim=1, keepdim=True) + 1e-10)
            yn = y / (y.norm(dim=1, keepdim=True) + 1e-10)
            total = total + ((xn - yn) ** 2).sum(dim=1).mean()
        return total / len(fa)

    def __call__(self, base_ct: torch.Tensor, generated_ct: torch.Tensor,
                 dimension: str = "axial") -> torch.Tensor:
        """base/generated: (B, 1, D, H, W)."""
        axis = {"axial": 2, "coronal": 3, "sagittal": 4}[dimension]
        n_total = base_ct.shape[axis]
        n = min(LPIPS_SLICES, n_total)
        scores = []
        for i in np.linspace(0, n_total - 1, n).astype(np.int32):
            sl_a = base_ct.select(axis, int(i))[:, 0]  # (B, X, Y)
            sl_b = generated_ct.select(axis, int(i))[:, 0]
            a = (2.0 * sl_a - 1.0).unsqueeze(1).expand(-1, 3, -1, -1)
            b = (2.0 * sl_b - 1.0).unsqueeze(1).expand(-1, 3, -1, -1)
            scores.append(self._lpips_2d(a, b))
        return torch.stack(scores).mean()

    def forward_multi_view(self, base_ct: torch.Tensor,
                           generated_ct: torch.Tensor) -> Dict[str, torch.Tensor]:
        ax = self(base_ct, generated_ct, "axial")
        co = self(base_ct, generated_ct, "coronal")
        sa = self(base_ct, generated_ct, "sagittal")
        return {"lpips_axial": ax, "lpips_coronal": co, "lpips_sagittal": sa,
                "lpips_average": (ax + co + sa) / 3.0}


class ComprehensiveFeatureMetrics:
    """Per-level MSE / cosine / Pearson / feature-SSIM / Gram style, their
    means over levels, and LPIPS. Volumes are (B, 1, D, H, W). weights,
    lpips_weights: converted state dicts (``convert.diagnostic_nets``), else
    seeded from ``EXTRACTOR_SEED`` and ``LPIPS_SEED``."""

    def __init__(self, weights: Optional[Mapping[str, torch.Tensor]] = None,
                 lpips_weights: Optional[Mapping[str, torch.Tensor]] = None):
        self._extractor = _frozen(MultiLevelFeatureExtractor(), EXTRACTOR_SEED, weights)
        self._lpips = LPIPS3D(weights=lpips_weights)

    def __call__(self, base_ct: torch.Tensor, generated_ct: torch.Tensor) -> Dict[str, torch.Tensor]:
        ext = _on(self._extractor, base_ct)
        fb = ext(base_ct.float())
        fg = ext(generated_ct.float())
        metrics: Dict[str, torch.Tensor] = {}
        for lvl in fb:
            a, b = fb[lvl], fg[lvl]
            metrics[f"{lvl}_mse"] = ((a - b) ** 2).mean()
            metrics[f"{lvl}_cosine"] = _feature_cosine(a, b)
            metrics[f"{lvl}_correlation"] = _feature_correlation(a, b)
            metrics[f"{lvl}_ssim"] = _feature_ssim(a, b)
            metrics[f"{lvl}_style"] = ((_gram(a) - _gram(b)) ** 2).mean()
        for name in ("mse", "cosine", "correlation", "ssim", "style"):
            vals = [v for k, v in metrics.items() if k.endswith(name)]
            metrics[f"overall_feature_{name}"] = sum(vals) / len(vals)
        metrics.update(self._lpips.forward_multi_view(base_ct, generated_ct))
        return metrics
