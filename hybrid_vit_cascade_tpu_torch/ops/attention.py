"""Multi-head attention core (counterpart of hybrid_vit_cascade_tpu/ops/attention.py).

Shapes: q (B, H, Nq, Dh), k/v (B, H, Nk, Dh) → (B, H, Nq, Dh).

``impl`` is the config's ``model.attn_impl``, dispatched as the JAX
dispatcher does (its ops/attention.py:139-227): "auto" and "flash" take the
flash kernels, "xla" the plain score-materialising ``_reference_attention``
on any device, and "flash_sharded" raises the JAX package's ValueError for a
call without an ambient model>1 mesh (the port has no model axis); any other
value is refused. On a CUDA tensor the kernel path launches the flash kernels
(forward: kernel A, reached through the ``hvc::flash_attention_fwd``
operator of ops/cuda/library.py; backward: kernel D, or kernels L then M
when ``FUSED_BWD`` is false; ops/cuda/flash_attention.py), at any head dim
up to 128 (a d other than 32, 64 and 128 zero-padded to the next); on a CPU
tensor it runs their plain versions.
The forward saves q, k, v, out and the natural-log lse, and the backward
recomputes the probabilities from them, as the JAX package's flash custom
VJP does. ``return_probs=True`` takes the plain score-materialising path of
the JAX ``_reference_attention`` instead, on any device, and also returns the
fp32 probabilities (the cross-attention capture). Not ported: the head- and
sequence-sharded mesh paths and the token-count threshold of the JAX
dispatcher, which are TPU-mesh and TPU-tiling constructs.
"""

from __future__ import annotations

import os

import torch

from ..config import ATTN_IMPLS
from .cuda import flash_attention as fa
from .cuda import library  # noqa: F401  (registers the hvc:: operators)

# The backward: the fused kernel D (default) or the split kernels L + M. Set
# as the JAX package sets its own switch (ops/pallas/flash_attention.py:70),
# the one HVC_* variable the port reads; callers may set the attribute, which
# every backward reads when it runs.
FUSED_BWD = os.environ.get("HVC_FLASH_FUSED_BWD", "1") != "0"


class _FlashAttention(torch.autograd.Function):
    """(q, k, v) (BH, N, d) → out, with the flash backward as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        out, lse = torch.ops.hvc.flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = fa.flash_attention_bwd if FUSED_BWD else fa.flash_attention_bwd_split
        dq, dk, dv = bwd(q, k, v, out, lse, dout.contiguous(), ctx.scale)
        return dq, dk, dv, None


def _reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, probs): fp32 scores and softmax, the probabilities rounded to q's
    dtype before the PV product, fp32 accumulation, out in q's dtype."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(q.dtype).float(), v.float()).to(q.dtype)
    return out, probs


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float | None = None, impl: str = "auto",
                          return_probs: bool = False):
    """softmax(q·kᵀ·scale)·v with fp32 softmax statistics and accumulation,
    output in q's dtype; differentiable. ``impl`` ∈ ATTN_IMPLS picks the path
    (module docstring). ``return_probs=True`` returns ``(out, probs)`` with
    the (B, H, Nq, Nk) fp32 probabilities, computed on the plain path (it
    materialises the scores: small token counts only)."""
    B, H, nq, d = q.shape
    nk = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attention impl must be one of {ATTN_IMPLS}, got {impl!r}")
    if impl == "flash_sharded":
        if return_probs:
            raise ValueError(
                "return_probs=True is incompatible with impl='flash_sharded': "
                "a streamed sharded kernel never materializes the (Nq, Nk) "
                "probability map. Use impl='xla' (small token counts only).")
        raise ValueError(
            f"flash_sharded needs an ambient (data, model) mesh dividing "
            f"(B={B}, H={H}) or (B, Nq={nq}); mesh=None")
    if return_probs:
        return _reference_attention(q, k, v, scale)
    if impl == "xla":
        return _reference_attention(q, k, v, scale)[0]
    out = _FlashAttention.apply(q.reshape(B * H, nq, d).contiguous(),
                                k.reshape(B * H, nk, d).contiguous(),
                                v.reshape(B * H, nk, d).contiguous(), scale)
    return out.reshape(B, H, nq, d)
