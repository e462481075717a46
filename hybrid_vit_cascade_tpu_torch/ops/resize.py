"""Separable linear resize (counterpart of hybrid_vit_cascade_tpu/ops/resize.py).

The JAX module reproduces torch's ``F.interpolate`` coordinate conventions
with per-axis interpolation matrices; here ``F.interpolate`` itself is the
forward, and the backward is those matrices transposed (``_LinearResize``):
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
    y = _LinearResize.apply(x.reshape(-1, 1, *x.shape[-2:]).float(), out_hw, align_corners)
    return y.reshape(*lead, *out_hw).to(x.dtype)


def resize_trilinear(x: torch.Tensor, out_dhw: Sequence[int],
                     align_corners: bool = False) -> torch.Tensor:
    """Trilinear resize of the three trailing axes (..., D, H, W)."""
    out_dhw = tuple(int(s) for s in out_dhw)
    if tuple(x.shape[-3:]) == out_dhw:
        return x
    lead = x.shape[:-3]
    y = _LinearResize.apply(x.reshape(-1, 1, *x.shape[-3:]).float(), out_dhw, align_corners)
    return y.reshape(*lead, *out_dhw).to(x.dtype)


class _LinearResize(torch.autograd.Function):
    """``F.interpolate``'s (bi/tri)linear resize of (N, 1, *spatial) forward;
    the backward is the transpose of the per-axis interpolation matrices,
    one matmul an axis (JAX's resize is those matrices both ways), over
    RESIZE_CHUNK_BYTES of the gradient at a time. It adds in a fixed order,
    so a training step gives the same bits from run to run:
    ``F.interpolate``'s own CUDA backward adds with atomics."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, out_size: tuple, align_corners: bool) -> torch.Tensor:
        ctx.in_size, ctx.align_corners = tuple(x.shape[2:]), align_corners
        mode = "bilinear" if len(out_size) == 2 else "trilinear"
        return F.interpolate(x, size=out_size, mode=mode, align_corners=align_corners)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        step = max(1, RESIZE_CHUNK_BYTES // (g[:1].numel() * g.element_size()))
        if step >= g.shape[0]:
            return _resize_vjp(g, ctx.in_size, ctx.align_corners), None, None
        dx = g.new_empty((g.shape[0], g.shape[1], *ctx.in_size))
        for i in range(0, g.shape[0], step):
            dx[i:i + step] = _resize_vjp(g[i:i + step], ctx.in_size, ctx.align_corners)
        return dx, None, None


# fp32 bytes of the output gradient the resize's backward contracts at once:
# each axis's product copies its slab and makes a result of up to its size,
# and the CNN decoders resize 128 channels to 256³ (8.6 GB in fp32)
RESIZE_CHUNK_BYTES = 1 << 30


def _resize_vjp(g: torch.Tensor, in_size: tuple, align_corners: bool) -> torch.Tensor:
    """g (N, 1, *out) through the transposed interpolation matrices, one
    matmul an axis."""
    for axis, n_in in zip(range(2, g.dim()), in_size):
        if g.shape[axis] != n_in:
            mat = _resize_matrix_on(n_in, g.shape[axis], align_corners, g.device)
            g = (g.movedim(axis, -1) @ mat.to(g.dtype)).movedim(-1, axis)
    return g


@functools.lru_cache(maxsize=None)
def _resize_matrix_on(in_size: int, out_size: int, align_corners: bool,
                      device: torch.device) -> torch.Tensor:
    """``_linear_resize_matrix`` on ``device``, copied there once: a copy
    from the host inside every backward would stall the stream."""
    return torch.from_numpy(_linear_resize_matrix(in_size, out_size, align_corners)).to(device)


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
