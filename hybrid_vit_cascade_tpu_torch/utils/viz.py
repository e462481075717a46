"""Figures and memory reports (counterpart of
hybrid_vit_cascade_tpu/utils/viz.py); matplotlib Agg, imported when a figure
is drawn. Feature maps come in the port's channels-first layout, (B, C, H, W)
or (B, C, D, H, W), where the JAX package's are channels-last."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_training_curves(jsonl_log: str, out_png: str) -> None:
    """Loss / PSNR / SSIM curves from the trainer's JSONL log."""
    rows = [json.loads(l) for l in Path(jsonl_log).read_text().splitlines() if l.strip()]
    if not rows:
        return
    plt = _plt()
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    epochs = [r.get("epoch", i) for i, r in enumerate(rows)]
    for ax, key, label in zip(axes, ("train_loss", "psnr", "ssim"), ("loss", "PSNR (dB)", "SSIM")):
        vals = [r.get(key) for r in rows]
        ax.plot(epochs, vals)
        ax.set_xlabel("epoch")
        ax.set_ylabel(label)
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)


def plot_feature_maps(features: np.ndarray, out_png: str, max_channels: int = 16,
                      title: str = "") -> None:
    """Grid of the first item's 2D feature-map channels, (B, C, H, W); of
    (B, C, D, H, W) features the mid-depth slice."""
    f = np.asarray(features)
    if f.ndim == 5:  # (B, C, D, H, W) → mid depth slice
        f = f[0, :, f.shape[2] // 2]
    elif f.ndim == 4:  # (B, C, H, W)
        f = f[0]
    C = min(f.shape[0], max_channels)
    cols = int(np.ceil(np.sqrt(C)))
    rows = int(np.ceil(C / cols))
    plt = _plt()
    fig, axes = plt.subplots(rows, cols, figsize=(2 * cols, 2 * rows))
    axes = np.atleast_1d(axes).ravel()
    for i in range(C):
        axes[i].imshow(f[i], cmap="viridis")
        axes[i].axis("off")
    for ax in axes[C:]:
        ax.axis("off")
    fig.suptitle(title)
    fig.savefig(out_png, dpi=100, bbox_inches="tight")
    plt.close(fig)


def compare_stage_outputs(stage_volumes: Dict[str, np.ndarray], target: Optional[np.ndarray],
                          out_png: str) -> None:
    """Per-stage axial / coronal / sagittal mid-slice grid, one column a
    stage and one for the ground truth."""
    plt = _plt()
    names = list(stage_volumes)
    ncols = len(names) + (1 if target is not None else 0)
    fig, axes = plt.subplots(3, ncols, figsize=(3 * ncols, 9), squeeze=False)
    planes = ["axial", "coronal", "sagittal"]

    def mid_slices(v):
        v = np.asarray(v)
        while v.ndim > 3:
            v = v[0]
        D, H, W = v.shape
        return [v[D // 2], v[:, H // 2], v[:, :, W // 2]]

    columns = [(name, stage_volumes[name]) for name in names]
    if target is not None:
        columns.append(("ground truth", target))
    for col, (name, vol) in enumerate(columns):
        for r, sl in enumerate(mid_slices(vol)):
            axes[r, col].imshow(sl, cmap="gray")
            axes[r, col].axis("off")
            if r == 0:
                axes[r, col].set_title(name)
            if col == 0:
                axes[r, col].set_ylabel(planes[r])
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


def plot_attention_salience(probs: np.ndarray, out_png: str, title: str = "") -> None:
    """Cross-attention salience mid-slices: per-voxel-token attention mass
    (the mean over heads and X-ray context positions of the captured fp32
    (B, H, N, M) probabilities) on the token cube; a 1D profile when N is no
    cube."""
    p = np.asarray(probs, np.float32)
    sal = p[0].mean(axis=(0, -1))  # (N,) attention mass per voxel token
    s = round(len(sal) ** (1.0 / 3.0))
    plt = _plt()
    if s ** 3 != len(sal):
        fig, ax = plt.subplots(figsize=(6, 2.5))
        ax.plot(sal)
        ax.set_title(title)
        fig.savefig(out_png, dpi=100, bbox_inches="tight")
        plt.close(fig)
        return
    cube = sal.reshape(s, s, s)
    fig, axes = plt.subplots(1, 3, figsize=(9, 3))
    for ax, sl, name in zip(axes, (cube[s // 2], cube[:, s // 2], cube[:, :, s // 2]),
                            ("axial", "coronal", "sagittal")):
        ax.imshow(sl, cmap="viridis")
        ax.set_title(name, fontsize=9)
        ax.axis("off")
    fig.suptitle(title)
    fig.savefig(out_png, dpi=110, bbox_inches="tight")
    plt.close(fig)


def device_memory_report() -> Dict[str, Dict[str, float]]:
    """Per-card memory in GB from ``torch.cuda.memory_stats`` (allocated now
    and at the peak) and the card's capacity; {} without a card."""
    import torch

    report = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        stats = torch.cuda.memory_stats(i)
        report[str(torch.device("cuda", i))] = {
            "bytes_in_use_gb": stats.get("allocated_bytes.all.current", 0) / 1024 ** 3,
            "peak_bytes_gb": stats.get("allocated_bytes.all.peak", 0) / 1024 ** 3,
            "limit_gb": torch.cuda.get_device_properties(i).total_memory / 1024 ** 3,
        }
    return report


def estimate_memory_usage(volume_size: Sequence[int], batch_size: int, voxel_dim: int,
                          dtype_bytes: int = 2) -> Dict[str, float]:
    """Rough activation memory estimate in GB: the volume, a token budget of
    min(32, max(16, D/8))³ tokens, 32-channel conv activations, the sum
    × 2.5 for forward and backward."""
    d, h, w = volume_size
    vox = d * h * w
    token_budget = min(32, max(16, d // 8)) ** 3
    est = {
        "volume_gb": batch_size * vox * dtype_bytes / 1024 ** 3,
        "tokens_gb": batch_size * token_budget * voxel_dim * dtype_bytes / 1024 ** 3,
        "conv_activations_gb": batch_size * vox * 32 * dtype_bytes / 1024 ** 3,
    }
    est["total_estimate_gb"] = sum(est.values()) * 2.5  # fwd+bwd fudge
    return est


def inference_summary_figure(xrays: np.ndarray, predicted: np.ndarray,
                             target: Optional[np.ndarray], metrics: Optional[Dict[str, float]],
                             out_png: str) -> None:
    """The 18-panel inference figure: a 3×6 grid of the input X-rays,
    predicted axial slices at D/4, D/2, 3D/4, predicted sagittal and coronal,
    a frontal maximum-intensity projection (MIP), the matching target slices
    and hot error maps, with a PSNR / MAE / SSIM title.

    xrays: (B, 2, 1, H, W); predicted / target: (B, 1, D, H, W) in [-1, 1]."""
    plt = _plt()
    xr = np.asarray(xrays)
    pred = np.asarray(predicted, np.float32)
    D, Hv, Wv = pred.shape[2:]
    fig = plt.figure(figsize=(20, 10))

    def panel(pos, img, title, cmap="gray", vmin=None, vmax=None, cbar=True):
        ax = plt.subplot(3, 6, pos)
        im = ax.imshow(img, cmap=cmap, vmin=vmin, vmax=vmax)
        ax.set_title(title)
        ax.axis("off")
        if cbar:
            plt.colorbar(im, ax=ax, fraction=0.046)

    panel(1, xr[0, 0, 0], "Input X-ray (AP)", cbar=False)
    panel(2, xr[0, 1, 0], "Input X-ray (Lateral)", cbar=False)
    axial_ds = (D // 4, D // 2, 3 * D // 4)
    for i, d in enumerate(axial_ds):
        panel(3 + i, pred[0, 0, d], f"Predicted (Axial D={d})", vmin=-1, vmax=1)
    panel(6, pred[0, 0, :, Hv // 2, :], "Predicted (Sagittal)", vmin=-1, vmax=1)
    panel(7, pred[0, 0, :, :, Wv // 2], "Predicted (Coronal)", vmin=-1, vmax=1)
    panel(8, pred[0, 0].max(axis=0), "MIP (Frontal)")
    if target is not None:
        tgt = np.asarray(target, np.float32)
        for i, d in enumerate(axial_ds):
            panel(9 + i, tgt[0, 0, d], f"Target (Axial D={d})", vmin=-1, vmax=1)
        panel(12, tgt[0, 0, :, Hv // 2, :], "Target (Sagittal)", vmin=-1, vmax=1)
        err = np.abs(pred - tgt)
        for i, d in enumerate(axial_ds):
            panel(15 + i, err[0, 0, d], f"Error (Axial D={d})", cmap="hot", vmin=0, vmax=0.5)
        panel(18, err[0, 0, :, Hv // 2, :], "Error (Sagittal)", cmap="hot", vmin=0, vmax=0.5)
    title = "Direct Regression Inference"
    if metrics:
        title += (f" - PSNR: {metrics.get('psnr', float('nan')):.2f} dB | "
                  f"MAE: {metrics.get('mae', float('nan')):.4f} | "
                  f"SSIM: {metrics.get('ssim', float('nan')):.3f}")
    plt.suptitle(title, fontsize=16, fontweight="bold")
    fig.tight_layout()
    fig.savefig(out_png, dpi=120, bbox_inches="tight")
    plt.close(fig)
