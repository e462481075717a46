"""Multi-head self/cross attention (counterpart of
hybrid_vit_cascade_tpu/models/attention.py:42-109).

The core runs through ops.attention with the module's ``attn_impl`` (the
config's ``model.attn_impl``, which ``build_model`` sets on every attention
module through ``set_attn_impl``), which launches the flash kernels on a
CUDA tensor. ``check_head_dims`` refuses up front a model that the kernels
cannot run on the card (a head dim over 128). Dropout acts on the attention
output and after the output projection, as in the JAX package (README
deviation 3: not on the probabilities).

The cross-attention capture: ``capture_attention`` sets
``store_attention`` on every ``MultiHeadCrossAttention`` under a module for
the forwards of a ``with`` block; each then takes the plain
score-materialising path and keeps the detached fp32 probabilities
(B, H, N, M) in ``attention_weights``, as the JAX module sows them, and
``collect_attention_maps`` gathers what was kept.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn

from ..ops.attention import dot_product_attention
from ..ops.cuda.flash_attention import kernel_head_dim
from .layers import DROPOUT_RATE, Dropout, Linear


def _attention_modules(model: nn.Module):
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, (MultiHeadSelfAttention, MultiHeadCrossAttention))]


def set_attn_impl(model: nn.Module, impl: str) -> nn.Module:
    """Every attention module under ``model`` takes ``impl`` (one of
    ``config.ATTN_IMPLS``; ``dot_product_attention`` refuses another) in its
    attention calls, as the JAX modules take their ``attn_impl`` field.
    Returns ``model``."""
    for _, m in _attention_modules(model):
        m.attn_impl = impl
    return model


def check_head_dims(model: nn.Module, device) -> None:
    """Refuse, before any step, a model whose attention the kernels cannot run
    on ``device``: on the card an attention module on the kernel path (every
    ``attn_impl`` but "xla") needs a head dim of at most 128
    (``kernel_head_dim``). The CPU runs the plain versions, which take any
    head dim."""
    if torch.device(device).type != "cuda":
        return
    for name, m in _attention_modules(model):
        if m.attn_impl != "xla":
            try:
                kernel_head_dim(m.head_dim)
            except ValueError as e:
                raise ValueError(f"{name}: {m.num_heads} heads of {m.head_dim}: {e}; "
                                 f"use more heads (attn_impl 'xla' takes any head dim but "
                                 f"materialises the scores: small token counts only)") from None


def collect_attention_maps(model: nn.Module) -> dict:
    """The cross-attention probabilities kept by the capturing modules of
    ``model`` (in ``model.modules()`` order) → {"cross_attention": the mean
    over those whose map has the first map's shape}, or {} when none
    captured: the dict DiagnosticLosses consumes."""
    maps = [m.attention_weights for m in model.modules()
            if isinstance(m, MultiHeadCrossAttention) and m.attention_weights is not None]
    if not maps:
        return {}
    same = [m for m in maps if m.shape == maps[0].shape]
    return {"cross_attention": sum(same) / len(same)}


@contextlib.contextmanager
def capture_attention(module: nn.Module):
    """Every cross-attention under ``module`` captures in the forwards inside
    the ``with`` block; on exit the flags are cleared and the kept maps
    dropped, so later forwards take the kernel path and hold no maps."""
    mods = [m for m in module.modules() if isinstance(m, MultiHeadCrossAttention)]
    for m in mods:
        m.store_attention, m.attention_weights = True, None
    try:
        yield
    finally:
        for m in mods:
            m.store_attention, m.attention_weights = False, None


class MultiHeadSelfAttention(nn.Module):
    """Fused-qkv softmax MHSA over voxel tokens; qkv has no bias, the output
    projection does. qkv splits as (B, N, 3, H, Dh)."""

    def __init__(self, embed_dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.attn_impl = "auto"  # set_attn_impl
        self.qkv = Linear(embed_dim, 3 * embed_dim, bias=False, dtype=dtype)
        self.proj = Linear(embed_dim, embed_dim, dtype=dtype)
        self.drop_attn = Dropout(DROPOUT_RATE)
        self.drop_proj = Dropout(DROPOUT_RATE)

    def forward(self, x: torch.Tensor, seed: int | None = None) -> torch.Tensor:
        B, N, E = x.shape
        H = self.num_heads
        Dh = E // H
        qkv = self.qkv(x).reshape(B, N, 3, H, Dh).permute(2, 0, 3, 1, 4)  # (3, B, H, N, Dh)
        out = dot_product_attention(qkv[0], qkv[1], qkv[2], scale=Dh ** -0.5,
                                    impl=self.attn_impl)
        out = self.drop_attn(out.transpose(1, 2).reshape(B, N, E), seed)
        return self.drop_proj(self.proj(out), seed)


class MultiHeadCrossAttention(nn.Module):
    """Q from voxel tokens, K/V from X-ray feature tokens; q and kv have no
    bias, the output projection does. kv splits as (B, M, 2, H, Dh).

    store_attention (set by ``capture_attention``): take the plain path and
    keep the detached fp32 probabilities of the last forward in
    ``attention_weights``."""

    def __init__(self, embed_dim: int, context_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.attn_impl = "auto"  # set_attn_impl
        self.store_attention = False
        self.attention_weights: torch.Tensor | None = None
        self.q = Linear(embed_dim, embed_dim, bias=False, dtype=dtype)
        self.kv = Linear(context_dim, 2 * embed_dim, bias=False, dtype=dtype)
        self.proj = Linear(embed_dim, embed_dim, dtype=dtype)
        self.drop_attn = Dropout(DROPOUT_RATE)
        self.drop_proj = Dropout(DROPOUT_RATE)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                seed: int | None = None) -> torch.Tensor:
        B, N, E = x.shape
        M = context.shape[1]
        H = self.num_heads
        Dh = E // H
        q = self.q(x).reshape(B, N, H, Dh).transpose(1, 2)
        kv = self.kv(context).reshape(B, M, 2, H, Dh).permute(2, 0, 3, 1, 4)
        if self.store_attention:
            out, probs = dot_product_attention(q, kv[0], kv[1], scale=Dh ** -0.5,
                                               impl=self.attn_impl, return_probs=True)
            self.attention_weights = probs.detach()
        else:
            out = dot_product_attention(q, kv[0], kv[1], scale=Dh ** -0.5,
                                        impl=self.attn_impl)
        out = self.drop_attn(out.transpose(1, 2).reshape(B, N, E), seed)
        return self.drop_proj(self.proj(out), seed)
