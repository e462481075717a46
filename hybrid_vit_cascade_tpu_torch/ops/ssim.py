"""3D SSIM from windowed statistics (counterpart of
hybrid_vit_cascade_tpu/ops/ssim.py): five zero-padded box filters (μ_p, μ_t,
E[p²], E[t²], E[pt]) with window 11 clamped to the volume and made odd,
C1 = 0.01², C2 = 0.03², all in fp32."""

from __future__ import annotations

import torch

from .pool import box_filter_same

C1 = 0.01 ** 2
C2 = 0.03 ** 2


def ssim3d_map(pred: torch.Tensor, target: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Per-voxel SSIM map of two (..., D, H, W) volumes (fp32)."""
    pred = pred.float()
    target = target.float()
    spatial = (-3, -2, -1)
    w = min(window_size, *(pred.shape[a] for a in spatial))
    if w % 2 == 0:
        w -= 1
    mu_p = box_filter_same(pred, w, spatial)
    mu_t = box_filter_same(target, w, spatial)
    mu_pp = mu_p * mu_p
    mu_tt = mu_t * mu_t
    mu_pt = mu_p * mu_t
    sigma_p = box_filter_same(pred * pred, w, spatial) - mu_pp
    sigma_t = box_filter_same(target * target, w, spatial) - mu_tt
    sigma_pt = box_filter_same(pred * target, w, spatial) - mu_pt
    return ((2.0 * mu_pt + C1) * (2.0 * sigma_pt + C2)) / (
        (mu_pp + mu_tt + C1) * (sigma_p + sigma_t + C2))


def ssim3d(pred: torch.Tensor, target: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM (scalar, fp32). Loss form is ``1 - ssim3d(...)``."""
    return ssim3d_map(pred, target, window_size).mean()
