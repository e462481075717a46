"""Dense evaluation of NCDHW conv→GroupNorm→activation chains (counterpart of
hybrid_vit_cascade_tpu/ops/slab.py:26-31, the chain spec, and :288-311,
``chain_apply_dense``).

Op spec (a list of tuples):
  ("conv", kernel (O, I, k, k, k), bias (O,) | None, stride)   k ∈ {1, 3}, stride ∈ {1, 2}
  ("gn",   num_groups, scale (C,), bias (C,))
  ("act",  "gelu" | "silu")
3×3×3 convs use padding 1 in all three dims and run through the
hand-written kernels; 1×1×1 convs are a channel contraction.

Not ported: the depth-slab streaming, the conv→GroupNorm folding and the
flat-layout path of slab.py. They exist to fit stage-3 training into a
15.75 GB TPU; the dense chain gives the same result to fp32 tolerance.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .conv3d import conv1x1_ncdhw, conv3d_ncdhw, group_norm_core


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":  # torch nn.GELU default (erf form)
        return F.gelu(x)
    if name == "silu":
        return F.silu(x)
    raise ValueError(name)


def chain_apply_dense(x: torch.Tensor, chain: Sequence[Tuple],
                      dtype: torch.dtype | None = None) -> torch.Tensor:
    """Whole-volume evaluation of the chain in the compute dtype."""
    dtype = dtype or x.dtype
    h = x.to(dtype)
    for op in chain:
        if op[0] == "conv":
            _, kernel, bias, stride = op
            if kernel.shape[-1] == 1 and stride == 1:
                h = conv1x1_ncdhw(h, kernel, bias)
            else:
                h = conv3d_ncdhw(h, kernel, bias, stride)
        elif op[0] == "gn":
            _, groups, scale, bias = op
            h = group_norm_core(h, scale, bias, groups).to(dtype)
        elif op[0] == "act":
            h = _act(op[1], h)
        else:
            raise ValueError(op[0])
    return h
