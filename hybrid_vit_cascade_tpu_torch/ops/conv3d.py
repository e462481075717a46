"""Feature-first (NCDHW) 3D conv + GroupNorm (counterpart of
hybrid_vit_cascade_tpu/ops/conv3d.py).

Every 3×3×3 conv goes through one autograd Function over the hand-written
kernels of ``ops/cuda/conv3d_k3.py`` (the forward through the
``hvc::conv3d_k3`` operator of ``ops/cuda/library.py``, the gradients
through the wrappers): ``conv3d_ncdhw`` for the padding-1
conv (kernels B-G), ``conv3d_chain`` for the slab-streamed chains of
``ops/slab.py`` (H-K); the dense conv is the chain conv over the whole
volume. The bias gradient is an fp32 sum, as the JAX package takes it
outside Pallas. A gradient is computed only for the inputs that need one.
On a CPU tensor each kernel wrapper runs its plain version.

Two GroupNorms, because the JAX package has two:
- ``group_norm_core`` (``ops/conv3d.py:64-116`` there, used by
  ``GroupNormNCDHW`` and the conv chains): fp32 statistics with
  var = E[x²] − E[x]² clamped at 0, eps 1e-5, the normalisation done in the
  input dtype, and the memory-lean hand-written VJP that keeps full tensors
  in the input dtype and only per-group scalars in fp32.
- ``group_norm_flax`` (flax ``nn.GroupNorm``, which the JAX package's
  ``models/layers.py:group_norm`` builds): fp32 statistics from the input
  promoted to fp32, normalisation and affine in fp32, one cast to the compute
  dtype at the end.
The two agree in fp32 and differ at bf16.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .cuda import library  # noqa: F401  (registers the hvc:: operators)
from .cuda.conv3d_k3 import conv3d_k3_dgrad, conv3d_k3_wgrad


class _Conv3dK3(torch.autograd.Function):
    """The 3×3×3 conv of the chain contract (``ops/cuda/conv3d_k3.py``) and
    its VJP as ``_vjp_bwd_chain`` computes it (``conv3d_k3.py:693-723``,
    ``conv3d_k3s2.py:621-641``): the stats cotangents fold into the output
    gradient, g + gs1 + 2·gs2·out in fp32, cast to x's dtype; the data
    gradient of x's planes with the act′ epilogue; the weight gradient with
    the prologue replayed, in w's dtype (the JAX VJP casts its fp32 kernel
    result to the weight's dtype); db = Σ g in fp32. ``dense`` marks the
    padding-1 conv, whose launches count under B-G."""

    @staticmethod
    def forward(ctx, x, w, bias, stride: int, qlo: int, d_out: int, want_sums: bool,
                act: Optional[str], dense: bool):
        out, s1, s2 = torch.ops.hvc.conv3d_k3(x, w, bias, stride, qlo, d_out, want_sums, act,
                                               dense)
        ctx.save_for_backward(x, w, out if want_sums else None)
        ctx.meta = (stride, qlo, want_sums, act, dense)
        return (out, s1, s2) if want_sums else out

    @staticmethod
    def backward(ctx, g, *stat_grads):
        x, w, out = ctx.saved_tensors
        stride, qlo, want_sums, act, dense = ctx.meta
        if want_sums:
            gs1, gs2 = (t[:, :, None, None, None] for t in stat_grads)
            g = g.float() + gs1 + 2.0 * gs2 * out.float()
        g = g.to(x.dtype).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv3d_k3_dgrad(g, w, x, stride, qlo, act, dense=dense)
        if ctx.needs_input_grad[1]:
            dw = conv3d_k3_wgrad(x, g, stride, qlo, act, dense=dense).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = g.float().sum(dim=(0, 2, 3, 4))
        return dx, dw, db, None, None, None, None, None, None


def _check_k3(fn: str, w: torch.Tensor, stride: int) -> None:
    if tuple(w.shape[2:]) != (3, 3, 3) or stride not in (1, 2):
        raise ValueError(f"{fn} takes 3×3×3 kernels at stride 1 or 2, got "
                         f"{tuple(w.shape)} stride {stride}")


def conv3d_ncdhw(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                 stride: int) -> torch.Tensor:
    """3×3×3 conv, padding 1, stride 1 or 2, on (B, Cin, D, H, W) in x's
    dtype; w (Cout, Cin, 3, 3, 3) is cast to x's dtype, the bias stays fp32
    and is added before the output is rounded. Differentiable. The chain
    conv over the whole volume: offset 1, ⌈D/S⌉ output planes."""
    _check_k3("conv3d_ncdhw", w, stride)
    bias = None if b is None else b.float().contiguous()
    return _Conv3dK3.apply(x.contiguous(), w.to(x.dtype).contiguous(), bias, stride, 1,
                           (x.shape[2] - 1) // stride + 1, False, None, True)


def conv3d_chain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], stride: int,
                 qlo: int, d_out: int, want_sums: bool = False, act: Optional[str] = None):
    """The slab-chain 3×3×3 conv, differentiable: x holds slab planes
    [qlo, qlo + x.shape[2]) (zeros elsewhere; its (D, H, W) planes contiguous,
    its batch and channel strides free), output plane o reads slab planes
    stride·o + {0, 1, 2}, H/W padding 1; w cast to x's dtype, bias fp32.
    Returns out (B, Cout, d_out, ·, ·) or (out, s1, s2) with per-(B, Cout)
    fp32 Σ, Σ² of the rounded output. ``act`` is the fused prologue."""
    _check_k3("conv3d_chain", w, stride)
    bias = None if b is None else b.float().contiguous()
    return _Conv3dK3.apply(x, w.to(x.dtype).contiguous(), bias, stride, qlo, d_out,
                           want_sums, act, False)


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


class _GroupNormCore(torch.autograd.Function):
    """GroupNorm forward (ops/conv3d.py:76-88 of the JAX package) and its
    hand-written VJP (:96-113): saves xhat in x's dtype and the per-group
    fp32 inverse std, nothing else of full size."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups: int):
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
        ctx.save_for_backward(xhat, inv, scale)
        ctx.num_groups = num_groups
        ctx.bias_dtype = bias.dtype
        return xhat * scale.to(x.dtype).reshape(bshape) + bias.to(x.dtype).reshape(bshape)

    @staticmethod
    def backward(ctx, g):
        xhat, inv, scale = ctx.saved_tensors
        B, C = xhat.shape[:2]
        G = ctx.num_groups
        g = g.to(xhat.dtype)
        param_axes = (0,) + tuple(range(2, xhat.dim()))
        dscale = (g * xhat).float().sum(dim=param_axes)
        dbias = g.float().sum(dim=param_axes)
        bshape = (1, C) + (1,) * (xhat.dim() - 2)
        gs = g * scale.to(g.dtype).reshape(bshape)
        gsr = gs.reshape(B, G, C // G, *xhat.shape[2:])
        xhr = xhat.reshape(B, G, C // G, *xhat.shape[2:])
        red = tuple(range(2, gsr.dim()))
        m1 = gsr.float().mean(dim=red, keepdim=True)
        m2 = (gsr * xhr).float().mean(dim=red, keepdim=True)
        dxr = (gsr - m1.to(g.dtype) - xhr * m2.to(g.dtype)) * inv.to(g.dtype)
        return (dxr.reshape(xhat.shape), dscale.to(scale.dtype), dbias.to(ctx.bias_dtype),
                None)


def group_norm_core(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    num_groups: int) -> torch.Tensor:
    """GroupNorm on (B, C, *spatial) with the JAX package's numerics and VJP
    (ops/conv3d.py:64-116); returns x's dtype."""
    return _GroupNormCore.apply(x, scale, bias, num_groups)


# fp32 bytes of the groups group_norm_flax normalises at once: a 256³ map of
# 192 channels is 12.9 GB in fp32, so its groups go in slices
GN_CHUNK_BYTES = 1 << 30


def group_norm_groups(groups: int, channels: int) -> int:
    """The largest group count ≤ ``groups`` that divides ``channels`` (the JAX
    package's ``_gn``, ``models/encoders.py:29``, and the decoders'
    ``_rdb_groups`` / ``_fusion_groups``)."""
    g = min(groups, channels)
    while channels % g != 0:
        g -= 1
    return g


def group_norm_flax_stats(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          num_groups: int, dtype: torch.dtype, out: torch.Tensor | None = None):
    """flax ``nn.GroupNorm``'s forward (``group_norm_flax``) without autograd:
    (y, per-(batch, group) fp32 mean, 1/std, groups a chunk). The chunks'
    outputs go into one tensor: ``out`` when given (of x's shape and
    ``dtype``; x itself is allowed, each chunk is read before it is
    written), else a new one."""
    C, G = x.shape[1], num_groups
    xr = x.unflatten(1, (G, C // G))
    red = tuple(range(2, xr.dim()))
    cshape = (1, G, C // G) + (1,) * (x.dim() - 2)
    sc, bi = scale.float().reshape(cshape), bias.float().reshape(cshape)
    step = max(1, GN_CHUNK_BYTES // (4 * max(1, xr[:, :1].numel())))
    yr = None if out is None else out.unflatten(1, (G, C // G))
    if yr is None and step < G:
        yr = torch.empty(xr.shape, dtype=dtype, device=x.device)
    means, rstds = [], []
    for g in range(0, G, step):
        xc = xr[:, g:g + step].float()
        mean = xc.mean(dim=red, keepdim=True)
        var = ((xc * xc).mean(dim=red, keepdim=True) - mean * mean).clamp_min(0.0)
        rstd = torch.rsqrt(var + 1e-5)
        y = ((xc - mean) * (rstd * sc[:, g:g + step]) + bi[:, g:g + step]).to(dtype)
        if yr is None:
            yr = y
        else:
            yr[:, g:g + step] = y
        means.append(mean)
        rstds.append(rstd)
    return yr.flatten(1, 2), torch.cat(means, 1), torch.cat(rstds, 1), step


def group_norm_flax_dx(xhat: torch.Tensor, gc: torch.Tensor, sc: torch.Tensor,
                       rstd: torch.Tensor) -> torch.Tensor:
    """The input gradient of group_norm_flax over one chunk of groups, fp32:
    xhat the chunk's normalised input (B, groups, C/G, ...), gc its output
    gradient in fp32, sc its scales and rstd its 1/std, broadcastable."""
    red = tuple(range(2, xhat.dim()))
    gs = gc * sc
    m1 = gs.mean(dim=red, keepdim=True)
    m2 = (gs * xhat).mean(dim=red, keepdim=True)
    return (gs - m1 - xhat * m2) * rstd


class _GroupNormFlax(torch.autograd.Function):
    """flax ``nn.GroupNorm`` forward and its exact gradient, GN_CHUNK_BYTES
    of groups at a time, saving only x and the per-(batch, group) fp32 mean
    and 1/std: the normalised values are recomputed in the backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups: int, dtype: torch.dtype):
        y, mean, rstd, step = group_norm_flax_stats(x, scale, bias, num_groups, dtype)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.meta = (num_groups, step, bias.dtype)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, scale, mean, rstd = ctx.saved_tensors
        G, step, bias_dtype = ctx.meta
        B, C = x.shape[:2]
        xr, gr = x.unflatten(1, (G, C // G)), gy.unflatten(1, (G, C // G))
        red = tuple(range(2, xr.dim()))  # a (batch, group)'s elements
        per_channel = (0,) + tuple(range(3, xr.dim()))
        sc = scale.float().reshape((1, G, C // G) + (1,) * (x.dim() - 2))
        dxs, dscale, dbias = [], [], []
        for g in range(0, G, step):
            s = slice(g, g + step)
            xhat = (xr[:, s].float() - mean[:, s]) * rstd[:, s]
            gc = gr[:, s].float()
            dbias.append(gc.sum(dim=per_channel))
            dscale.append((gc * xhat).sum(dim=per_channel))
            if ctx.needs_input_grad[0]:
                dxs.append(group_norm_flax_dx(xhat, gc, sc[:, s], rstd[:, s]).to(x.dtype))
        dx = None
        if dxs:
            dx = (dxs[0] if len(dxs) == 1 else torch.cat(dxs, 1)).flatten(1, 2)
        return (dx, torch.cat(dscale).reshape(C).to(scale.dtype),
                torch.cat(dbias).reshape(C).to(bias_dtype), None, None)


def group_norm_flax(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    num_groups: int, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.GroupNorm(epsilon=1e-5)`` on (B, C, *spatial), in the order
    of flax's ``_compute_stats`` and ``_normalize``: x promoted to fp32,
    mean and E[x²] in fp32, var = max(0, E[x²] − mean²), then
    y = (x − mean)·(rsqrt(var + eps)·scale) + bias in fp32, cast to ``dtype``.
    Groups go GN_CHUNK_BYTES of fp32 at a time (each group's numbers are the
    same either way). Differentiable, saving x and per-group statistics only."""
    return _GroupNormFlax.apply(x, scale, bias, num_groups, dtype)


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
    """torch nn.GroupNorm on (B, C, *spatial), output in the compute dtype.

    ``flax=False``: through ``group_norm_core`` (the JAX ``GroupNormNCDHW``).
    ``flax=True``: through ``group_norm_flax`` (the JAX sites that use flax
    ``nn.GroupNorm``: the channels-last token stem and the encoders)."""

    def __init__(self, num_groups: int, num_channels: int, dtype: torch.dtype = torch.float32,
                 flax: bool = False):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.compute_dtype = dtype
        self.flax = flax

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.flax:
            return group_norm_flax(x, self.weight, self.bias, self.num_groups, self.compute_dtype)
        return group_norm_core(x, self.weight, self.bias, self.num_groups).to(self.compute_dtype)
