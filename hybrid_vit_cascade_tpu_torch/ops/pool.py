"""Max pooling (counterpart of hybrid_vit_cascade_tpu/ops/pool.py:82-114).

torch's ``F.max_pool2d`` pads with -inf, which is the JAX module's
semantics. Only 2D max pooling is ported so far: the X-ray encoder is its
one caller on the inference path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_nd(x: torch.Tensor, window: int, stride: int | None = None,
                padding: int = 0) -> torch.Tensor:
    """torch F.max_pool2d over the (H, W) axes of an (N, C, H, W) tensor,
    padded with -inf; stride defaults to the window."""
    if x.dim() != 4:
        raise ValueError(f"expected (N, C, H, W), got {tuple(x.shape)}")
    return F.max_pool2d(x, window, stride=window if stride is None else stride, padding=padding)
