"""Separable linear resize (counterpart of hybrid_vit_cascade_tpu/ops/resize.py).

The JAX module reproduces torch's ``F.interpolate`` coordinate conventions
with per-axis interpolation matrices; here ``F.interpolate`` itself is the
implementation:
  * align_corners=True : src = i * (in-1) / (out-1)
  * align_corners=False: src = (i + 0.5) * in/out - 0.5, clamped to [0, in-1]
Like the JAX module it computes in fp32 and returns the input dtype.

``resize_trilinear_np`` is the host-side (numpy) resize of the data
pipeline, with the JAX module's interpolation matrices.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
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


@functools.lru_cache(maxsize=None)
def _linear_resize_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """(out_size, in_size) row-stochastic interpolation matrix (the JAX
    module's ``_linear_resize_matrix``)."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    rows = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = np.zeros_like(rows) if out_size == 1 else rows * (in_size - 1) / (out_size - 1)
    else:
        src = np.clip((rows + 0.5) * in_size / out_size - 0.5, 0.0, in_size - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = src - lo
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(mat, (np.arange(out_size), lo), 1.0 - frac)
    np.add.at(mat, (np.arange(out_size), hi), frac)
    return mat.astype(np.float32)


def resize_trilinear_np(vol: np.ndarray, out_dhw: Sequence[int],
                        align_corners: bool = False) -> np.ndarray:
    """Host-side (numpy) trilinear resize of the three trailing axes, one
    interpolation matrix per axis; fp32 out."""
    out = vol
    for axis, size in zip((-3, -2, -1), out_dhw):
        ax = axis % out.ndim
        if out.shape[ax] != int(size):
            mat = _linear_resize_matrix(out.shape[ax], int(size), align_corners)
            out = np.moveaxis(np.tensordot(out, mat, axes=[[ax], [1]]), -1, ax)
    return np.ascontiguousarray(out, dtype=np.float32)
