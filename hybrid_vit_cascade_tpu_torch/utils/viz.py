"""Inference figures (counterpart of ``_plt`` and ``inference_summary_figure``
in hybrid_vit_cascade_tpu/utils/viz.py); matplotlib Agg, imported when a
figure is drawn."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


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
