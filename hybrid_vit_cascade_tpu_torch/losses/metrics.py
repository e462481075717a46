"""Quality metrics in fp32 (counterpart of hybrid_vit_cascade_tpu/losses/metrics.py):
``psnr`` is the fixed-range form, ``psnr_dynamic_range`` the inference
scripts' variant over the target's observed range."""

from __future__ import annotations

import torch

from ..ops.ssim import ssim3d


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 2.0) -> torch.Tensor:
    """20·log10(range/√MSE); range 2.0 for [-1, 1] volumes."""
    return psnr_of_mse(mse(pred, target), data_range)


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred.float() - target.float()) ** 2).mean()


def psnr_of_mse(mse_: torch.Tensor, data_range: float = 2.0) -> torch.Tensor:
    return 20.0 * torch.log10(data_range / torch.sqrt(mse_.clamp_min(1e-12)))


def psnr_dynamic_range(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """PSNR with the target's observed dynamic range."""
    t = target.float()
    return psnr(pred, target, data_range=1.0) + 20.0 * torch.log10((t.max() - t.min()).clamp_min(1e-12))


def ssim_metric(pred: torch.Tensor, target: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean 3D SSIM (higher is better)."""
    return ssim3d(pred, target, window_size)


def mae(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred.float() - target.float()).abs().mean()

