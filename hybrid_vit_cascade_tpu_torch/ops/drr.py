"""Differentiable DRR projections (counterpart of
hybrid_vit_cascade_tpu/ops/drr.py). Volumes are (..., D, H, W).

- ``drr_beer_lambert``: exp(−μ·(volume + 1)) summed along the ray axis,
  clamped ≥ 1e-6; the lateral view sums over W and transposes to (…, H, D).
- ``drr_mean_projection``: the mean along D (AP) or W (lateral), resized
  bilinearly (align_corners=False) to (img_size, img_size) when given — the
  stage-3 reprojection loss.
"""

from __future__ import annotations

import torch

from .resize import resize_bilinear

MU = 0.3  # effective attenuation coefficient for [-1, 1] normalised volumes


def drr_beer_lambert(volume: torch.Tensor, view: str = "ap", mu: float = MU) -> torch.Tensor:
    attenuation = torch.exp(-mu * (volume.float() + 1.0))
    if view == "lateral":
        drr = attenuation.sum(dim=-1).transpose(-1, -2)  # (..., H, D)
    elif view == "ap":
        drr = attenuation.sum(dim=-3)  # (..., H, W)
    else:
        raise ValueError(f"unknown view {view!r}")
    return drr.clamp_min(1e-6)


def drr_mean_projection(volume: torch.Tensor, view: str = "ap",
                        img_size: int | None = 512) -> torch.Tensor:
    vol = volume.float()
    if view == "ap":
        drr = vol.mean(dim=-3)
    elif view == "lateral":
        drr = vol.mean(dim=-1)
    else:
        raise ValueError(f"unknown view {view!r}")
    if img_size is not None and tuple(drr.shape[-2:]) != (img_size, img_size):
        drr = resize_bilinear(drr, (img_size, img_size), align_corners=False)
    return drr
