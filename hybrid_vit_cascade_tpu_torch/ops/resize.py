"""Separable linear resize (counterpart of hybrid_vit_cascade_tpu/ops/resize.py).

The JAX module reproduces torch's ``F.interpolate`` coordinate conventions
with per-axis interpolation matrices; here ``F.interpolate`` itself is the
implementation:
  * align_corners=True : src = i * (in-1) / (out-1)
  * align_corners=False: src = (i + 0.5) * in/out - 0.5, clamped to [0, in-1]
Like the JAX module it computes in fp32 and returns the input dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw: Sequence[int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of the two trailing axes (..., H, W)."""
    out_hw = tuple(int(s) for s in out_hw)
    if tuple(x.shape[-2:]) == out_hw:
        return x
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape(-1, 1, *x.shape[-2:]).float(), size=out_hw,
                      mode="bilinear", align_corners=align_corners)
    return y.reshape(*lead, *out_hw).to(x.dtype)


def resize_trilinear(x: torch.Tensor, out_dhw: Sequence[int],
                     align_corners: bool = False) -> torch.Tensor:
    """Trilinear resize of the three trailing axes (..., D, H, W)."""
    out_dhw = tuple(int(s) for s in out_dhw)
    if tuple(x.shape[-3:]) == out_dhw:
        return x
    lead = x.shape[:-3]
    y = F.interpolate(x.reshape(-1, 1, *x.shape[-3:]).float(), size=out_dhw,
                      mode="trilinear", align_corners=align_corners)
    return y.reshape(*lead, *out_dhw).to(x.dtype)
