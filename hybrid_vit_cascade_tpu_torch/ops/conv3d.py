"""Feature-first (NCDHW) 3D conv + GroupNorm (counterpart of
hybrid_vit_cascade_tpu/ops/conv3d.py).

Every 3×3×3 conv with padding 1 goes through ``conv3d_ncdhw``, which on a
CUDA tensor launches the hand-written kernels of ``ops/cuda/conv3d_k3.py``
(stride 1: kernel B, stride 2: kernel C) and on a CPU tensor runs their
plain version. ``group_norm_core`` copies the JAX numerics, which differ
from ``nn.GroupNorm`` at bf16: fp32 statistics with var = E[x²] − E[x]²
clamped at 0, eps 1e-5, and the normalisation done in the input dtype.
Forward only: the memory-lean custom backward comes with training.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .cuda.conv3d_k3 import conv3d_k3s1, conv3d_k3s2


def conv3d_ncdhw(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                 stride: int) -> torch.Tensor:
    """3×3×3 conv, padding 1, stride 1 or 2, on (B, Cin, D, H, W) in x's
    dtype; w (Cout, Cin, 3, 3, 3) is cast to x's dtype, the bias stays fp32
    and is added before the output is rounded."""
    if tuple(w.shape[2:]) != (3, 3, 3) or stride not in (1, 2):
        raise ValueError(f"conv3d_ncdhw takes 3×3×3 kernels at stride 1 or 2, got "
                         f"{tuple(w.shape)} stride {stride}")
    fn = conv3d_k3s1 if stride == 1 else conv3d_k3s2
    bias = None if b is None else b.float().contiguous()
    return fn(x.contiguous(), w.to(x.dtype).contiguous(), bias)


def conv1x1_ncdhw(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """1×1×1 conv as a channel contraction (hybrid_vit_cascade_tpu/ops/slab.py
    :131-142): product in x's dtype with fp32 accumulation, bias added in
    x's dtype."""
    B, C = x.shape[:2]
    wm = w.reshape(w.shape[0], C).to(x.dtype)
    out = torch.matmul(wm, x.reshape(B, C, -1)).reshape(B, w.shape[0], *x.shape[2:])
    if b is not None:
        out = out + b.to(x.dtype)[None, :, None, None, None]
    return out


def group_norm_core(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    num_groups: int) -> torch.Tensor:
    """GroupNorm on (B, C, *spatial) with the JAX package's numerics
    (ops/conv3d.py:76-88); returns x's dtype."""
    B, C = x.shape[:2]
    G = num_groups
    xr = x.reshape(B, G, C // G, *x.shape[2:])
    red = tuple(range(2, xr.dim()))
    mean = xr.float().mean(dim=red, keepdim=True)
    mean2 = (xr * xr).float().mean(dim=red, keepdim=True)  # square in x's dtype, as JAX
    var = (mean2 - mean * mean).clamp_min(0.0)
    inv = torch.rsqrt(var + 1e-5)
    xhat = ((xr - mean.to(x.dtype)) * inv.to(x.dtype)).reshape(x.shape)
    bshape = (1, C) + (1,) * (x.dim() - 2)
    return xhat * scale.to(x.dtype).reshape(bshape) + bias.to(x.dtype).reshape(bshape)


class ConvNCDHW(nn.Conv3d):
    """3×3×3 conv with padding 1 on (B, C, D, H, W) (weights OIDHW), through
    the hand-written kernels. Parameters stay fp32; input and weight are cast
    to the compute dtype (flax's ``dtype=`` rule)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, 3, stride=stride, padding=1)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3d_ncdhw(x.to(self.compute_dtype), self.weight, self.bias, self.stride[0])


class GroupNormNCDHW(nn.Module):
    """torch nn.GroupNorm on (B, C, *spatial) through ``group_norm_core``
    (fp32 statistics, eps 1e-5), output in the compute dtype."""

    def __init__(self, num_groups: int, num_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_core(x, self.weight, self.bias, self.num_groups).to(self.compute_dtype)
