"""The CNN decoders' seven-component loss (counterpart of
hybrid_vit_cascade_tpu/losses/direct256.py).

Weights: L1 1.0, SSIM 0.5, focal frequency 0.2, perceptual pyramid 0.15,
TV 0.02, style 0.1, anatomical attention 0.3. Each component is reduced in
fp32 and clamped; a non-finite component value is zeroed where the JAX
package zeroes it, and a non-finite total falls back to L1 + SSIM + TV.

The perceptual, style and attention feature nets are frozen, fp32 3D conv
stacks (``F.conv3d``, a conv the JAX package leaves to XLA) with flax's
GroupNorm numerics. Their weights are, in order of preference, the JAX
nets' variables converted by ``convert.direct256_nets`` (``weights=``), or
by default drawn from a seeded ``torch.Generator`` with flax ``nn.Conv``'s
defaults (``lecun_normal`` kernels, zero biases): the same kind of frozen
random features, not JAX's draws (a flax seed cannot be replayed in torch).

With ``remat`` (the model config's ``use_gradient_checkpointing``, which
``single_model_step`` passes) each conv → GroupNorm → GELU layer of the nets
is one Function (``_ConvGNGelu``) that keeps only its input and the
per-group statistics and recomputes the conv in the backward, writing the
normalised map and then its gradient into the conv's output buffer: at 256³
a 128-channel fp32 map is 8.6 GB, and the plain autograd graph keeps three
of them a layer. Its backward runs the ops autograd runs through the three
layers, in the same order and on the same chunks of groups, so values and
gradients are bitwise those without it.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from ..ops.conv3d import group_norm_flax, group_norm_flax_dx, group_norm_flax_stats
from ..ops.fft import fft_magnitude_3d, half_spectrum_multiplicity, rfft_magnitude_3d
from ..ops.resize import resize_trilinear
from .multiscale import l1_loss, lecun_normal_, ssim_loss, total_variation_loss

# (out channels, kernel, GroupNorm groups or None) of each net's convs, from
# one input channel; the last conv of "style" has no norm and no activation,
# "attention" ends in a 1×1 conv and a sigmoid
NETS = {
    "pyramid": ((32, 3, 8), (64, 3, 16), (128, 3, 32)),
    "style": ((32, 3, 8), (64, 3, 16), (64, 3, None)),
    "attention": ((16, 3, 4), (32, 3, 8), (1, 1, None)),
}


def _finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def focal_frequency_loss(pred: torch.Tensor, target: torch.Tensor,
                         alpha: float = 1.0) -> torch.Tensor:
    """FFT-magnitude squared error, focally reweighted by the error over its
    per-volume sum; fp32, clamped to [0, 100]. Even sizes run on the rfft half
    spectrum with per-bin multiplicities, odd sizes on the full one."""
    shape = tuple(pred.shape[-3:])
    if all(s % 2 == 0 for s in shape):
        pm, tm = rfft_magnitude_3d(pred), rfft_magnitude_3d(target)
        mult = half_spectrum_multiplicity(shape, pred.device)
        dist = (pm - tm) ** 2
        norm = (dist * mult).sum(dim=(-3, -2, -1), keepdim=True)
        focal = torch.pow(dist / (norm + 1e-8), alpha)
        loss = (focal * dist * mult).sum() / pred.numel()
    else:
        pm, tm = fft_magnitude_3d(pred), fft_magnitude_3d(target)
        dist = (pm - tm) ** 2
        norm = dist.sum(dim=(-3, -2, -1), keepdim=True)
        loss = (torch.pow(dist / (norm + 1e-8), alpha) * dist).mean()
    return _finite_or_zero(loss.clamp(0.0, 100.0))


def seeded_nets(seed: int = 4242) -> Dict[str, Dict[str, torch.Tensor]]:
    """The three nets' weights from one seeded torch.Generator, in NETS
    order: flax nn.Conv's defaults, GroupNorm scales 1 and biases 0."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, convs in NETS.items():
        sd, cin, n_gn = {}, 1, 0
        for i, (cout, k, groups) in enumerate(convs):
            sd[f"Conv_{i}.weight"] = lecun_normal_(torch.empty(cout, cin, k, k, k), g)
            sd[f"Conv_{i}.bias"] = torch.zeros(cout)
            if groups is not None:
                sd[f"GroupNorm_{n_gn}.weight"] = torch.ones(cout)
                sd[f"GroupNorm_{n_gn}.bias"] = torch.zeros(cout)
                n_gn += 1
            cin = cout
        out[name] = sd
    return out


# Output elements a conv of the nets may write at once: the pyramid net's
# 64→128 layer at 256³ writes 128·256³ = 2³¹ fp32 values, one past int32's
# range, and cuDNN then ran its data gradient on a 64-bit-index direct kernel
# (11.5 s of a 16 s step on an H100, PERF.md §5). _ConvGNGelu runs such a
# conv, and its data gradient, in parts of output channels under the limit.
CONV_OUT_LIMIT = 2**31 - 1


def _out_parts(x: torch.Tensor, cout: int) -> list:
    """Output-channel slices of a same-size conv of x, each writing at most
    CONV_OUT_LIMIT elements."""
    per = max(1, CONV_OUT_LIMIT // x[:, :1].numel())
    return [slice(c, min(c + per, cout)) for c in range(0, cout, per)]


def _conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, pad: int) -> torch.Tensor:
    parts = _out_parts(x, weight.shape[0])
    if len(parts) == 1:
        return F.conv3d(x, weight, bias, padding=pad)
    out = x.new_empty((x.shape[0], weight.shape[0], *x.shape[2:]))
    for s in parts:
        out[:, s] = F.conv3d(x, weight[s], bias[s], padding=pad)
    return out


def _conv_dgrad(g: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, pad: int) -> torch.Tensor:
    """x's gradient of ``_conv`` from g, as autograd asks cuDNN for it (the
    weights take none), summed over the output-channel parts."""
    dx = None
    for s in _out_parts(x, weight.shape[0]):
        d = torch.ops.aten.convolution_backward(
            g[:, s].contiguous(), x, weight[s], [s.stop - s.start], [1] * 3, [pad] * 3, [1] * 3,
            False, [0] * 3, 1, [True, False, False])[0]
        dx = d if dx is None else dx.add_(d)
    return dx


class _ConvGNGelu(torch.autograd.Function):
    """GELU(flax GroupNorm(conv(x))) of a frozen net layer in fp32, saving x
    and the per-(batch, group) mean and 1/std only; gives x's gradient (the
    nets' weights take none). The backward recomputes the conv and the
    GroupNorm's output, takes the GELU's backward over the whole map (as
    autograd does: its vectorised and scalar parts must fall where they
    fell), then the GroupNorm's input gradient a chunk of groups at a time
    (group_norm_flax's chunks) written over the conv's output, and ends in
    the conv's input gradient (``aten.convolution_backward``, as autograd
    calls it). A conv of more than CONV_OUT_LIMIT outputs runs in parts of
    output channels both ways (``_conv``, ``_conv_dgrad``), which no test
    size reaches: there its bits are cuDNN's on the parts."""

    @staticmethod
    def forward(ctx, x, weight, bias, scale, shift, groups: int):
        h = _conv(x, weight, bias, weight.shape[-1] // 2)
        y, mean, rstd, step = group_norm_flax_stats(h, scale, shift, groups, torch.float32, out=h)
        ctx.save_for_backward(x, weight, bias, scale, shift, mean, rstd)
        ctx.meta = (groups, step)
        return torch.ops.aten.gelu_(y)

    @staticmethod
    def backward(ctx, gout):
        x, weight, bias, scale, shift, mean, rstd = ctx.saved_tensors
        G, step = ctx.meta
        pad = weight.shape[-1] // 2
        h = _conv(x, weight, bias, pad)
        C = h.shape[1]
        hr = h.unflatten(1, (G, C // G))
        cshape = (1, G, C // G) + (1,) * (h.dim() - 2)
        sc, bi = scale.float().reshape(cshape), shift.float().reshape(cshape)
        chunks = [slice(g, g + step) for g in range(0, G, step)]
        y = torch.empty_like(hr)
        for s in chunks:
            y[:, s] = (hr[:, s] - mean[:, s]) * (rstd[:, s] * sc[:, s]) + bi[:, s]
        y = y.flatten(1, 2)
        gy = torch.ops.aten.gelu_backward.grad_input(gout, y, grad_input=y).unflatten(
            1, (G, C // G))
        for s in chunks:
            r = rstd[:, s]
            hr[:, s] = group_norm_flax_dx((hr[:, s] - mean[:, s]) * r, gy[:, s], sc[:, s], r)
        del y, gy
        return _conv_dgrad(h, x, weight, pad), None, None, None, None, None


def feature_net(name: str, weights: Mapping[str, torch.Tensor], x: torch.Tensor,
                remat: bool = False) -> torch.Tensor:
    """Net ``name`` on x (B, 1, D, H, W) in fp32: conv → GroupNorm → GELU per
    NETS entry with groups (one ``_ConvGNGelu`` with ``remat``), a bare conv
    otherwise; the attention net's output through a sigmoid."""
    x = x.float()
    n_gn = 0
    for i, (_, k, groups) in enumerate(NETS[name]):
        w, b = weights[f"Conv_{i}.weight"], weights[f"Conv_{i}.bias"]
        if groups is None:
            x = F.conv3d(x, w, b, padding=k // 2)
            continue
        scale, shift = weights[f"GroupNorm_{n_gn}.weight"], weights[f"GroupNorm_{n_gn}.bias"]
        n_gn += 1
        if remat:
            x = _ConvGNGelu.apply(x, w, b, scale, shift, groups)
        else:
            x = F.gelu(group_norm_flax(F.conv3d(x, w, b, padding=k // 2), scale, shift, groups,
                                       torch.float32))
    return torch.sigmoid(x) if name == "attention" else x


class Direct256Loss:
    """Resolution-agnostic seven-component loss; returns the JAX package's
    keys. ``weights``: {"pyramid", "style", "attention"} state dicts (see the
    module docstring), else the nets are drawn from ``seed``; ``remat``: the
    nets' layers recompute in the backward (the module docstring)."""

    def __init__(self, l1_weight: float = 1.0, ssim_weight: float = 0.5,
                 focal_freq_weight: float = 0.2, perceptual_pyramid_weight: float = 0.15,
                 tv_weight: float = 0.02, style_weight: float = 0.1,
                 anatomical_weight: float = 0.3,
                 weights: Optional[Mapping[str, Mapping[str, torch.Tensor]]] = None,
                 seed: int = 4242, remat: bool = False):
        self.w = dict(l1=l1_weight, ssim=ssim_weight, focal=focal_freq_weight,
                      pyramid=perceptual_pyramid_weight, tv=tv_weight, style=style_weight,
                      anatomical=anatomical_weight)
        nets = seeded_nets(seed) if weights is None else weights
        self._nets = {n: {k: v.detach().float() for k, v in sd.items()} for n, sd in nets.items()}
        self.remat = remat

    def _net(self, name: str, x: torch.Tensor) -> torch.Tensor:
        sd = self._nets[name]
        if next(iter(sd.values())).device != x.device:
            sd = self._nets[name] = {k: v.to(x.device) for k, v in sd.items()}
        return feature_net(name, sd, x, self.remat)

    def perceptual_pyramid(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """L1 of the pyramid net's features at scales 1, 0.5 and 0.25
        (trilinear, align_corners=False), each clamped to [0, 100]."""
        total = 0.0
        for scale in (1.0, 0.5, 0.25):
            p, t = pred, target
            if scale != 1.0:
                size = tuple(int(s * scale) for s in pred.shape[-3:])
                p = resize_trilinear(pred, size, align_corners=False)
                t = resize_trilinear(target, size, align_corners=False)
            diff = (self._net("pyramid", p) - self._net("pyramid", t)).abs().mean()
            total = total + _finite_or_zero(diff).clamp(0.0, 100.0)
        return _finite_or_zero(total / 3.0)

    def style3d(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """MSE of the style net's Gram matrices, each over N·C and clamped to
        ±1e3."""

        def gram(feat):  # (B, C, D, H, W)
            flat = feat.flatten(2)  # (B, C, N)
            g = torch.bmm(flat, flat.transpose(1, 2))
            return (g / max(1.0, float(flat.shape[2] * flat.shape[1]))).clamp(-1e3, 1e3)

        loss = ((gram(self._net("style", pred)) - gram(self._net("style", target))) ** 2).mean()
        return _finite_or_zero(loss.clamp(0.0, 100.0))

    def anatomical_attention(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """0.7·attention-weighted L1 + 0.3·uniform L1; the attention net reads
        the target's gradient magnitude, min-max normalised (0.5 where flat),
        without a gradient."""
        t = target.float()
        gd = F.pad((t[..., 1:, :, :] - t[..., :-1, :, :]).abs(), (0, 0, 0, 0, 0, 1))
        gh = F.pad((t[..., :, 1:, :] - t[..., :, :-1, :]).abs(), (0, 0, 0, 1, 0, 0))
        gw = F.pad((t[..., :, :, 1:] - t[..., :, :, :-1]).abs(), (0, 1, 0, 0, 0, 0))
        imp = (gd + gh + gw) / 3.0
        lo, hi = imp.min(), imp.max()
        rng = hi - lo
        imp = torch.where(rng > 1e-6, (imp - lo) / (rng + 1e-8), torch.full_like(imp, 0.5))
        attention = self._net("attention", imp.detach())
        weighted = (attention * (pred.float() - t).abs()).mean()
        uniform = l1_loss(pred, target)
        return _finite_or_zero(0.7 * weighted.clamp(0.0, 100.0) + 0.3 * uniform.clamp(0.0, 100.0))

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> Dict[str, torch.Tensor]:
        l1 = l1_loss(pred, target).clamp(0.0, 100.0)
        ssim = ssim_loss(pred, target).clamp(0.0, 100.0)
        focal = focal_frequency_loss(pred, target)
        pyramid = self.perceptual_pyramid(pred, target)
        tv = total_variation_loss(pred, target).clamp(0.0, 100.0)
        style = self.style3d(pred, target)
        anatomical = self.anatomical_attention(pred, target)
        w = self.w
        total = (w["l1"] * l1 + w["ssim"] * ssim + w["focal"] * focal + w["pyramid"] * pyramid
                 + w["tv"] * tv + w["style"] * style + w["anatomical"] * anatomical)
        total = torch.where(torch.isfinite(total), total, l1 + ssim + tv)
        return {"total_loss": total, "l1_loss": l1, "ssim_loss": ssim, "focal_freq_loss": focal,
                "perceptual_pyramid_loss": pyramid, "tv_loss": tv, "style_loss": style,
                "anatomical_loss": anatomical}


def get_loss_summary_string(loss_dict: Mapping[str, torch.Tensor]) -> str:
    """One log line of a Direct256Loss dict."""
    f = lambda k: float(loss_dict[k])  # noqa: E731
    return (f"Loss: {f('total_loss'):.4f} | L1: {f('l1_loss'):.4f} | "
            f"SSIM: {f('ssim_loss'):.4f} | FocalFreq: {f('focal_freq_loss'):.4f} | "
            f"Perceptual: {f('perceptual_pyramid_loss'):.4f} | TV: {f('tv_loss'):.4f} | "
            f"Style: {f('style_loss'):.4f} | Anatomical: {f('anatomical_loss'):.4f}")
