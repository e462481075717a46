"""Pooling with the JAX module's (torch-exact) semantics (counterpart of
hybrid_vit_cascade_tpu/ops/pool.py).

- ``box_filter_same``: stride-1 mean filter, zero padding window//2 and the
  full window volume as divisor (torch ``avg_pool3d(count_include_pad=True)``,
  the SSIM statistics), done separably, one axis at a time, in fp32.
- ``avg_pool_nd``: torch ``F.avg_poolNd(count_include_pad=True)`` over the
  given axes.
- ``max_pool_nd``: torch ``F.max_pool2d`` / ``F.max_pool3d``, which pad with
  -inf as the JAX module does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _to_trailing(x: torch.Tensor, axes: Sequence[int]) -> tuple[torch.Tensor, list[int]]:
    """x with ``axes`` moved to the end and every other axis folded into one
    leading axis, plus the permutation that did it."""
    axes = [a % x.dim() for a in axes]
    rest = [a for a in range(x.dim()) if a not in axes]
    perm = rest + axes
    y = x.permute(perm)
    return y.reshape(-1, 1, *y.shape[len(rest):]), perm


def _from_trailing(y: torch.Tensor, x: torch.Tensor, perm: list[int]) -> torch.Tensor:
    lead = [x.shape[a] for a in perm[: x.dim() - (y.dim() - 2)]]
    y = y.reshape(*lead, *y.shape[2:])
    inv = [0] * len(perm)
    for i, a in enumerate(perm):
        inv[a] = i
    return y.permute(inv)


_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def avg_pool_nd(x: torch.Tensor, window: int | Sequence[int], spatial_axes: Sequence[int],
                stride: int | Sequence[int] | None = None,
                padding: int | Sequence[int] = 0) -> torch.Tensor:
    """torch F.avg_poolNd with count_include_pad=True over ``spatial_axes``
    (1 to 3 of them), in fp32, returned in x's dtype."""
    n = len(spatial_axes)
    windows = [window] * n if isinstance(window, int) else list(window)
    strides = windows if stride is None else ([stride] * n if isinstance(stride, int) else list(stride))
    pads = [padding] * n if isinstance(padding, int) else list(padding)
    y, perm = _to_trailing(x.float(), spatial_axes)
    y = _AVG_POOL[n](y, windows, strides, pads, count_include_pad=True)
    return _from_trailing(y, x, perm).to(x.dtype)


def box_filter_same(x: torch.Tensor, window: int, spatial_axes: Sequence[int]) -> torch.Tensor:
    """Stride-1 mean filter over ``spatial_axes`` with zero padding window//2,
    dividing by the full window volume; odd windows only, as in JAX."""
    if window % 2 != 1:
        raise ValueError("box_filter_same requires an odd window")
    out = x.float()
    for axis in spatial_axes:
        out = avg_pool_nd(out, window, (axis,), stride=1, padding=window // 2)
    return out.to(x.dtype)


def max_pool_nd(x: torch.Tensor, window: int, stride: int | None = None,
                padding: int = 0) -> torch.Tensor:
    """torch F.max_pool2d / F.max_pool3d over the spatial axes of an
    (N, C, H, W) / (N, C, D, H, W) tensor, padded with -inf; stride defaults
    to the window."""
    pool = {4: F.max_pool2d, 5: F.max_pool3d}.get(x.dim())
    if pool is None:
        raise ValueError(f"expected (N, C, H, W) or (N, C, D, H, W), got {tuple(x.shape)}")
    return pool(x, window, stride=window if stride is None else stride, padding=padding)
