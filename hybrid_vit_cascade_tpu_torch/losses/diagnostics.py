"""Diagnostic loss suite and component-health grades (counterpart of
hybrid_vit_cascade_tpu/losses/diagnostics.py). Volumes are NCDHW.

Nine instrumented loss categories that isolate architectural components:
diffusion MSE, single / multi-view / multi-scale DRR projection, depth
consistency, cross-attention entropy and sparsity, the stage-transition
frequency split, a 3D perceptual distance, the anatomical-prior improvement
and the feature-metric suite. For debugging and ablation, not a training
objective. The frozen nets' filters: see ``losses/feature_metrics.py`` (by
default seeded torch filters, not JAX's; ``weights=`` takes converted ones).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.drr import drr_beer_lambert
from ..ops.pool import avg_pool_nd, max_pool_nd
from ..ops.resize import resize_bilinear, resize_trilinear
from .feature_metrics import ComprehensiveFeatureMetrics, _frozen, _on

PERCEPTUAL_SEED = 7

LOSS_WEIGHTS = {
    "diffusion": 1.0,
    "projection_single": 0.3,
    "projection_multi_view": 0.2,
    "projection_multi_scale": 0.1,
    "depth_consistency": 0.15,
    "cross_attention_align": 0.1,
    "stage_transition": 0.2,
    "perceptual": 0.1,
    "frequency_low": 0.05,
    "frequency_high": 0.05,
    "anatomical_prior": 0.1,
    "feature_mse": 0.15,
    "feature_cosine": 0.1,
    "feature_correlation": 0.05,
    "lpips": 0.2,
}


class Simple3DPerceptualNet(nn.Module):
    """conv(1→32)/ReLU/max-pool 2 → conv(32→64)/ReLU/max-pool 2 →
    conv(64→128)/ReLU → spatial mean: (B, 1, D, H, W) → (B, 128)."""

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(nn.Conv3d(cin, cout, 3, padding=1)
                                   for cin, cout in ((1, 32), (32, 64), (64, 128)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(self.convs):
            x = F.relu(conv(x))
            if i < 2:
                x = max_pool_nd(x, 2)
        return x.mean(dim=(2, 3, 4))


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a.float() - b.float()) ** 2).mean()


def _resize_to(img: torch.Tensor, hw) -> torch.Tensor:
    return resize_bilinear(img, tuple(hw), align_corners=True)


class DiagnosticLosses:
    """Frozen-feature diagnostic suite; ``__call__`` returns every loss (0-d
    fp32 tensors) and their ``LOSS_WEIGHTS``-weighted ``total``.

    weights: ``{"perceptual", "extractor", "lpips"}`` state dicts
    (``convert.diagnostic_nets``); without them each net is seeded (the
    perceptual net from ``PERCEPTUAL_SEED``, the others from their modules'
    seeds). The nets follow the inputs' device."""

    def __init__(self, weights: Optional[Mapping[str, Mapping[str, torch.Tensor]]] = None):
        weights = weights or {}
        self._perceptual = _frozen(Simple3DPerceptualNet(), PERCEPTUAL_SEED,
                                   weights.get("perceptual"))
        self._feature_metrics = ComprehensiveFeatureMetrics(weights=weights.get("extractor"),
                                                            lpips_weights=weights.get("lpips"))

    def __call__(
        self,
        predicted: torch.Tensor,  # (B, 1, D, H, W) predicted noise / velocity
        target: torch.Tensor,
        pred_x0: torch.Tensor,
        gt_x0: torch.Tensor,
        xrays: torch.Tensor,  # (B, V, 1, S, S)
        depth_prior: Optional[torch.Tensor] = None,
        prev_stage_volume: Optional[torch.Tensor] = None,
        attention_maps: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Dict[str, torch.Tensor]:
        losses: Dict[str, torch.Tensor] = {}
        zero = torch.zeros((), dtype=torch.float32, device=pred_x0.device)

        # 1. diffusion
        losses["diffusion"] = _mse(predicted, target)

        # 2. projections (Beer-Lambert; bilinear align_corners=True size match)
        xray_ap = xrays[:, 0, 0].float()
        drr_pred = drr_beer_lambert(pred_x0[:, 0], "ap")
        drr_gt = drr_beer_lambert(gt_x0[:, 0], "ap")
        if drr_pred.shape[-2:] != xray_ap.shape[-2:]:
            drr_pred = _resize_to(drr_pred, xray_ap.shape[-2:])
            drr_gt = _resize_to(drr_gt, xray_ap.shape[-2:])
        losses["projection_single"] = _mse(drr_pred, xray_ap)
        losses["projection_gt_sanity"] = _mse(drr_gt, xray_ap)

        if xrays.shape[1] > 1:
            xray_lat = xrays[:, 1, 0].float()
            drr_lat = drr_beer_lambert(pred_x0[:, 0], "lateral")
            if drr_lat.shape[-2:] != xray_lat.shape[-2:]:
                drr_lat = _resize_to(drr_lat, xray_lat.shape[-2:])
            losses["projection_multi_view"] = _mse(drr_lat, xray_lat)
        else:
            losses["projection_multi_view"] = zero

        ms = [_mse(_resize_to(drr_pred, (s, s)), _resize_to(xray_ap, (s, s))) for s in (64, 128)]
        losses["projection_multi_scale"] = sum(ms) / 2.0

        # 3. depth consistency
        if depth_prior is not None:
            pf = pred_x0.reshape(pred_x0.shape[0], -1).float()
            df = depth_prior.reshape(depth_prior.shape[0], -1).float()
            cos = ((pf * df).sum(-1) / (pf.norm(dim=-1) * df.norm(dim=-1) + 1e-8)).mean()
            losses["depth_consistency"] = (cos - 0.45) ** 2
            losses["depth_prior_quality"] = _mse(depth_prior, gt_x0)
        else:
            losses["depth_consistency"] = zero
            losses["depth_prior_quality"] = zero

        # 4. cross-attention alignment
        if attention_maps is not None and "cross_attention" in attention_maps:
            attn = attention_maps["cross_attention"].mean(dim=1)  # (B, N, M)
            probs = torch.softmax(attn.float(), dim=-1)
            entropy = -(probs * torch.log(probs + 1e-8)).sum(-1).mean()
            target_entropy = torch.log(torch.tensor(float(probs.shape[-1]))) * 0.6
            losses["cross_attention_align"] = (entropy - target_entropy) ** 2
            losses["cross_attention_sparsity"] = -probs.max(dim=-1).values.mean()
        else:
            losses["cross_attention_align"] = zero
            losses["cross_attention_sparsity"] = zero

        # 5. stage transition: the k4/s1/p2 low-pass split
        if prev_stage_volume is not None:
            prev_up = resize_trilinear(prev_stage_volume, pred_x0.shape[-3:], align_corners=True)
            lp = avg_pool_nd(pred_x0, 4, spatial_axes=(-3, -2, -1), stride=1, padding=2)
            lprev = avg_pool_nd(prev_up, 4, spatial_axes=(-3, -2, -1), stride=1, padding=2)
            losses["stage_transition"] = _mse(lp, lprev)
            # k4/s1/p2 pooling emits size+1 maps; the residual uses the first
            # `size` entries so the high-frequency part matches the volume
            D, H, W = pred_x0.shape[-3:]
            hp = pred_x0.float() - lp[..., :D, :H, :W]
            hprev = prev_up.float() - lprev[..., :D, :H, :W]
            losses["stage_detail_addition"] = -_mse(hp, hprev)
        else:
            losses["stage_transition"] = zero
            losses["stage_detail_addition"] = zero

        # 6. frequency split (k8/s8 pool → trilinear up, align_corners=True)
        def lowpass(v):
            p = avg_pool_nd(v, 8, spatial_axes=(-3, -2, -1))
            return resize_trilinear(p, v.shape[-3:], align_corners=True)

        pl_, gl = lowpass(pred_x0), lowpass(gt_x0)
        losses["frequency_low"] = _mse(pl_, gl)
        losses["frequency_high"] = _mse(pred_x0.float() - pl_, gt_x0.float() - gl)

        # 7. perceptual
        net = _on(self._perceptual, pred_x0)
        losses["perceptual"] = _mse(net(pred_x0.float()), net(gt_x0.float()))

        # 8. anatomical prior improvement
        if depth_prior is not None:
            prior_err = _mse(depth_prior, gt_x0)
            pred_err = _mse(pred_x0, gt_x0)
            improvement = (prior_err - pred_err) / (prior_err + 1e-8)
            losses["anatomical_prior"] = F.relu(-improvement)
            losses["prior_improvement_ratio"] = improvement.detach()
        else:
            losses["anatomical_prior"] = zero
            losses["prior_improvement_ratio"] = zero

        # 9. feature metrics / LPIPS
        fm = self._feature_metrics(gt_x0, pred_x0)
        losses["feature_mse"] = fm["overall_feature_mse"]
        losses["feature_cosine"] = 1.0 - fm["overall_feature_cosine"]
        losses["feature_correlation"] = 1.0 - fm["overall_feature_correlation"]
        losses["feature_ssim"] = 1.0 - fm["overall_feature_ssim"]
        losses["feature_style"] = fm["overall_feature_style"]
        for k, v in fm.items():
            if k.startswith("level_"):
                losses[f"diagnostic_{k}"] = v
        for k in ("lpips", "lpips_axial", "lpips_coronal", "lpips_sagittal"):
            losses[k] = fm["lpips_average" if k == "lpips" else k]

        total = zero
        for name, value in losses.items():
            if name in LOSS_WEIGHTS and not name.endswith("_sanity"):
                total = total + LOSS_WEIGHTS[name] * value
        losses["total"] = total
        return losses


def _is_scalar(v) -> bool:
    return v.dim() == 0 if isinstance(v, torch.Tensor) else np.ndim(v) == 0


def analyze_component_health(losses: Mapping) -> Dict[str, str]:
    """EXCELLENT / GOOD / WARNING / CRITICAL grade of each component from the
    scalar losses (0-d tensors or floats)."""
    f = {k: float(v) for k, v in losses.items() if _is_scalar(v)}
    health: Dict[str, str] = {}

    def grade(val, bands, labels=("EXCELLENT", "GOOD", "WARNING", "CRITICAL")):
        for b, lab in zip(bands, labels):
            if val < b:
                return lab
        return labels[-1]

    health["denoising"] = grade(f.get("diffusion", 0.0), (0.01, 0.05, 0.1))
    health["physics"] = grade(f.get("projection_single", 0.0), (0.005, 0.02, 0.05))
    if f.get("depth_consistency", 0.0) > 0:
        corr = 0.45 - f["depth_consistency"] ** 0.5
        if corr > 0.5:
            health["depth_lifting"] = "EXCELLENT"
        elif corr > 0.3:
            health["depth_lifting"] = "GOOD"
        elif corr > 0.1:
            health["depth_lifting"] = "WARNING"
        else:
            health["depth_lifting"] = "CRITICAL - Prior being ignored"
    if f.get("cross_attention_align", 0.0) > 0:
        v = f["cross_attention_align"]
        health["cross_attention"] = (
            "EXCELLENT" if v < 0.1 else "GOOD" if v < 0.3 else "WARNING" if v < 0.5
            else "CRITICAL - Attention collapsed")
    if "frequency_low" in f and "frequency_high" in f:
        lo, hi = f["frequency_low"], f["frequency_high"]
        if lo > 2 * hi:
            health["structure_vs_details"] = "WARNING - Struggling with anatomy"
        elif hi > 2 * lo:
            health["structure_vs_details"] = "WARNING - Missing fine details"
        else:
            health["structure_vs_details"] = "GOOD - Balanced"
    if f.get("stage_transition", 0.0) > 0:
        v = f["stage_transition"]
        health["cascade"] = (
            "EXCELLENT - Smooth transition" if v < 0.01 else "GOOD" if v < 0.05
            else "WARNING - Stages disconnected" if v < 0.1 else "CRITICAL - Cascade not coherent")
    if f.get("feature_mse", 0.0) > 0:
        v = f["feature_mse"]
        health["feature_accuracy"] = (
            "EXCELLENT - Features match well" if v < 0.01 else "GOOD" if v < 0.05
            else "WARNING - Feature mismatch" if v < 0.1 else "CRITICAL - Features very different")
    if f.get("lpips", 0.0) > 0:
        v = f["lpips"]
        health["perceptual_similarity"] = (
            "EXCELLENT - Perceptually identical" if v < 0.1 else "GOOD" if v < 0.3
            else "WARNING - Perceptual differences" if v < 0.5
            else "CRITICAL - Very different perceptually")
    return health
