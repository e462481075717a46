"""Shared building-block layers (counterpart of hybrid_vit_cascade_tpu/models/layers.py).

Parameters are fp32; each module takes a compute ``dtype`` and follows the
flax ``dtype=`` rule rather than autocast: a dense layer casts its input,
weight and bias to the compute dtype, and LayerNorm takes its statistics in
fp32 and returns the compute dtype. Dropout is the identity at inference and
is left out.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Linear(nn.Linear):
    """nn.Linear computing in ``dtype`` over fp32 parameters."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.LayerNorm):
    """torch nn.LayerNorm (eps 1e-5, affine) with fp32 statistics, output in
    ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=1e-5)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class Mlp(nn.Module):
    """Transformer MLP: Linear → GELU → Linear."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden_dim, dtype=dtype)
        self.fc2 = Linear(hidden_dim, out_dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))  # erf form, as torch nn.GELU


class AdaLNModulation(nn.Module):
    """cond (B, cond_dim) → six (B, 1, E) modulations, in the order shift_sa,
    scale_sa, gate_sa, shift_mlp, scale_mlp, gate_mlp. Zero-initialised so a
    fresh block starts as the identity."""

    def __init__(self, cond_dim: int, embed_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear = Linear(cond_dim, 6 * embed_dim, dtype=dtype)
        nn.init.zeros_(self.linear.weight)
        nn.init.zeros_(self.linear.bias)

    def forward(self, cond: torch.Tensor):
        return self.linear(cond)[:, None, :].chunk(6, dim=-1)


def seeded_init_(module: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter from one seeded torch.Generator, in name order:
    weights of rank ≥ 2 U(±1/√fan_in), norm scales 1 + 0.1·N(0, 1), biases
    0.1·N(0, 1), ``pos_embed`` 0.02·N(0, 1), ``initial_volume`` 0.01·N(0, 1);
    the cascade's blend weights keep their constant init. Non-zero AdaLN
    weights make every gated path count. For smoke runs and tests: there is
    no trained checkpoint in the repository."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(module.named_parameters()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("residual_weight", "detail_weight"):
                continue
            if leaf == "pos_embed":
                new = 0.02 * torch.randn(p.shape, generator=g)
            elif leaf == "initial_volume":
                new = 0.01 * torch.randn(p.shape, generator=g)
            elif p.dim() >= 2:
                bound = (p[0].numel()) ** -0.5
                new = (torch.rand(p.shape, generator=g) * 2 - 1) * bound
            elif leaf in ("weight",) or leaf.endswith("_scale"):
                new = 1.0 + 0.1 * torch.randn(p.shape, generator=g)
            else:
                new = 0.1 * torch.randn(p.shape, generator=g)
            p.copy_(new.to(p.dtype))
    return module
