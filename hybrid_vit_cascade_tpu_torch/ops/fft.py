"""3D FFT helpers for the frequency loss (counterpart of
hybrid_vit_cascade_tpu/ops/fft.py:17-84): magnitudes in fp32 on the full
spectrum or on the rfft half spectrum, the reference's radial high-frequency
mask (distance > min/4 from the centre index of the unshifted layout) and the
per-bin multiplicity that makes half-spectrum sums equal full-cube sums."""

from __future__ import annotations

import functools

import numpy as np
import torch


def fft_magnitude_3d(x: torch.Tensor) -> torch.Tensor:
    """|FFT3(x)| over the three trailing axes, in fp32."""
    return torch.abs(torch.fft.fftn(x.float(), dim=(-3, -2, -1)))


def rfft_magnitude_3d(x: torch.Tensor) -> torch.Tensor:
    """|FFT3(x)| on the half spectrum (..., D, H, W//2+1) of a real input."""
    return torch.abs(torch.fft.rfftn(x.float(), dim=(-3, -2, -1)))


@functools.lru_cache(maxsize=None)
def _half_mult_np(w: int) -> np.ndarray:
    """Bins 0 (and W/2 for even W) count once, every other kept bin twice."""
    mult = np.full((w // 2 + 1,), 2.0, np.float32)
    mult[0] = 1.0
    if w % 2 == 0:
        mult[w // 2] = 1.0
    return mult


@functools.lru_cache(maxsize=None)
def _high_freq_mask_np(d: int, h: int, w: int) -> np.ndarray:
    """1.0 where the unshifted-spectrum distance from (D/2, H/2, W/2) > min/4."""
    radius = min(d, h, w) // 4
    dd = np.arange(d, dtype=np.float32) - d // 2
    hh = np.arange(h, dtype=np.float32) - h // 2
    ww = np.arange(w, dtype=np.float32) - w // 2
    dist = np.sqrt(dd[:, None, None] ** 2 + hh[None, :, None] ** 2 + ww[None, None, :] ** 2)
    return (dist > radius).astype(np.float32)


def half_spectrum_multiplicity(shape_dhw, device=None) -> torch.Tensor:
    """(1, 1, W//2+1) full-cube multiplicity weights for the rfft layout."""
    return torch.from_numpy(_half_mult_np(int(shape_dhw[-1]))).to(device)[None, None, :]


def high_freq_mask(shape_dhw, device=None) -> torch.Tensor:
    """(D, H, W) high-frequency mask."""
    return torch.from_numpy(_high_freq_mask_np(*(int(s) for s in shape_dhw))).to(device)


def high_freq_mask_half(shape_dhw, device=None) -> torch.Tensor:
    """The high-frequency mask on the rfft half spectrum (D, H, W//2+1)."""
    d, h, w = (int(s) for s in shape_dhw)
    return torch.from_numpy(
        np.ascontiguousarray(_high_freq_mask_np(d, h, w)[:, :, : w // 2 + 1])).to(device)
