"""Shared building-block layers (counterpart of hybrid_vit_cascade_tpu/models/layers.py).

Parameters are fp32; each module takes a compute ``dtype`` and follows the
flax ``dtype=`` rule rather than autocast: a dense layer casts its input,
weight and bias to the compute dtype, and LayerNorm takes its statistics in
fp32 and returns the compute dtype.

Dropout (the JAX ``FastDropout``, ``layers.py:33``) is driven by an integer
``seed`` that the caller draws from its ``torch.Generator`` once per forward
(``None`` = deterministic, the JAX ``train=False``). Each site draws its mask
from a generator seeded with (seed, site number), so a recomputation under
activation checkpointing sees the same mask as the forward it replays. Like
the JAX module it keeps with probability 1 − rate and scales by
1/(1 − rate); the bits differ from JAX's, as JAX's differ from the
reference's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

# The rate of every dropout site: the JAX modules' default, which no cascade
# configuration changes.
DROPOUT_RATE = 0.1


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


class Dropout(nn.Module):
    """Inverted dropout at ``rate``; ``site`` numbers it within its model
    (``number_dropout_sites``)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.site = 0

    def forward(self, x: torch.Tensor, seed: int | None) -> torch.Tensor:
        if seed is None or self.rate == 0.0:
            return x
        gen = torch.Generator(device=x.device)
        gen.manual_seed((seed * 1_000_003 + self.site) % (1 << 63))
        keep = torch.rand(x.shape, generator=gen, device=x.device) >= self.rate
        return torch.where(keep, x / torch.tensor(1.0 - self.rate, dtype=x.dtype), 0.0)


def number_dropout_sites(module: nn.Module) -> None:
    """Give every Dropout under ``module`` a distinct site number, in module
    order (so two models built alike number alike)."""
    for i, m in enumerate(m for m in module.modules() if isinstance(m, Dropout)):
        m.site = i


class Mlp(nn.Module):
    """Transformer MLP: Linear → GELU → Dropout → Linear → Dropout."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden_dim, dtype=dtype)
        self.fc2 = Linear(hidden_dim, out_dim, dtype=dtype)
        self.drop1 = Dropout(DROPOUT_RATE)
        self.drop2 = Dropout(DROPOUT_RATE)

    def forward(self, x: torch.Tensor, seed: int | None = None) -> torch.Tensor:
        h = self.drop1(F.gelu(self.fc1(x)), seed)  # erf form, as torch nn.GELU
        return self.drop2(self.fc2(h), seed)


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
