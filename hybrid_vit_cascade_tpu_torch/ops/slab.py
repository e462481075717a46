"""D-slab streaming of NCDHW conv→GroupNorm→activation chains (counterpart of
hybrid_vit_cascade_tpu/ops/slab.py).

The JAX package evaluates the stage-3 256³ conv branches in depth slabs: a
chain with K GroupNorms runs one pass per GroupNorm, each accumulating that
norm's global (Σ, Σ²) as its endpoint conv's epilogue, stores an endpoint
when recomputing it would cost more than ``store_min_flops``, runs the rest
dense once every remaining level fits ``dense_max_voxels``, and folds a
conv→GroupNorm pair into the conv's weights at batch 1. It does so on every
``train=False`` call (the cascade's default eval schedule, one slab, every
endpoint stored) and, with ``stage3_slab_scan``, in training (the shipped
config: 8 slabs). The port runs the same schedules so that it computes what
the JAX package computes, through the chain forms of the conv kernels
(``ops/conv3d.py:conv3d_chain``, kernels H-K).

Op spec (a list of tuples):
  ("conv", kernel (O, I, k, k, k), bias (O,) | None, stride)   k ∈ {1, 3}, stride ∈ {1, 2}
  ("gn",   num_groups, scale (C,), bias (C,))
  ("act",  "gelu" | "silu")
Convs use padding k//2 in H/W and, in the dense form, in D; in a slab body
they are VALID in D over the slab with its halo, and the planes outside the
volume read as zeros (each conv zero-pads its own input, as the dense conv).

From JAX to here:
- ``lax.scan(jax.checkpoint(body))`` is a Python loop over slabs; each body
  runs under ``torch.utils.checkpoint`` (non-reentrant) while autograd
  records, so its activations are recomputed in the backward. Emitted slabs
  are concatenated along D; the stats carry is an fp32 sum over slabs.
- A slab is never copied out of its source: a contiguous NCDHW tensor is the
  TPU package's flat layout already, and the chain kernels take the part of
  the slab inside the volume as a D-narrowed view plus its plane offset and
  zero every other plane at the load. So neither the clamped-slice-plus-roll
  halo of ``_slice_slab`` nor a padded copy of the source exists here, and
  ``_slice_slab_flat`` / ``_group_sums_flat`` have no counterpart.
- The environment switches become keywords with the JAX defaults:
  ``HVC_ACT_FUSE`` (off) → ``act_fuse=False``; ``HVC_GN_FOLD`` (on) →
  ``gn_fold=True``. The port reads one ``HVC_*`` variable only, the JAX
  package's flash backward switch ``HVC_FLASH_FUSED_BWD``
  (``ops/attention.py:FUSED_BWD``).

Numerics match ``ops.conv3d.group_norm_core`` (fp32 statistics, var =
E[x²] − E[x]² clamped ≥ 0, eps 1e-5); the statistics are taken over the
rounded conv output, as in the kernels' epilogue.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .conv3d import conv1x1_ncdhw, conv3d_chain, conv3d_ncdhw, group_norm_core

# A slab in flight: (h, q0, n) — a slab of n planes whose planes
# [q0, q0 + h.shape[2]) are h; the planes it does not hold lie outside the
# volume and read as zeros.
Slab = Tuple[torch.Tensor, int, int]


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":  # torch nn.GELU default (erf form)
        return F.gelu(x)
    if name == "silu":
        return F.silu(x)
    raise ValueError(name)


def chain_apply_dense(x: torch.Tensor, chain: Sequence[Tuple],
                      dtype: torch.dtype | None = None) -> torch.Tensor:
    """Whole-volume evaluation of the chain in the compute dtype (the
    numerical oracle of the slab schedules)."""
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


def _walk_back(chain: Sequence[Tuple], upto: int, start: int = 0) -> Tuple[int, int, int]:
    """Affine map from an output D-range [s, e) at op index `upto` (exclusive)
    back to the required input D-range [F·s + c_lo, F·e + c_hi) at op index
    `start` (through chain[start:upto]).

    conv k3 s1: [s-1, e+1) ; conv k3 s2: [2s-1, 2e) ; k1 / gn / act: identity.
    """
    F_, c_lo, c_hi = 1, 0, 0
    for op in reversed(chain[start:upto]):
        if op[0] != "conv":
            continue
        k, stride = op[1].shape[-1], op[3]
        if stride == 2:
            if k != 3:
                raise ValueError("the slab walk takes k3 for strided convs")
            F_, c_lo, c_hi = 2 * F_, 2 * c_lo - 1, 2 * c_hi
        elif k == 3:
            c_lo, c_hi = c_lo - 1, c_hi + 1
        elif k != 1:
            raise ValueError(f"the slab walk takes k1 and k3 convs, got k{k}")
    return F_, c_lo, c_hi


def _level_shape(chain: Sequence[Tuple], upto: int, in_shape,
                 start: int = 0) -> Tuple[int, int, int, int]:
    """(C, D, H, W) of the activation entering op index `upto`, given the
    activation entering op index `start` has shape `in_shape` (NCDHW)."""
    C, D, H, W = in_shape[1], in_shape[2], in_shape[3], in_shape[4]
    for op in chain[start:upto]:
        if op[0] == "conv":
            C = op[1].shape[0]
            s = op[3]
            D, H, W = D // s, H // s, W // s
    return C, D, H, W


def _conv_flops(chain: Sequence[Tuple], start: int, end: int, in_shape) -> float:
    """MAC-pair FLOPs of the convs in chain[start:end] on a full volume."""
    total = 0.0
    D, H, W = in_shape[2], in_shape[3], in_shape[4]
    for op in chain[start:end]:
        if op[0] == "conv":
            o, cin, k = op[1].shape[0], op[1].shape[1], op[1].shape[-1]
            s = op[3]
            D, H, W = D // s, H // s, W // s
            total += 2.0 * in_shape[0] * o * cin * (k ** 3) * D * H * W
    return total


def _gn_normalize(x: torch.Tensor, groups: int, scale: torch.Tensor, bias: torch.Tensor,
                  mean: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """GroupNorm with given global per-(B, G) stats, in the normalisation
    arithmetic of group_norm_core (x's dtype)."""
    B, C = x.shape[:2]
    xr = x.reshape(B, groups, C // groups, *x.shape[2:])
    bc = (B, groups) + (1,) * (xr.dim() - 2)
    xhat = ((xr - mean.reshape(bc).to(x.dtype)) * inv.reshape(bc).to(x.dtype)).reshape(x.shape)
    bshape = (1, C) + (1,) * (x.dim() - 2)
    return xhat * scale.to(x.dtype).reshape(bshape) + bias.to(x.dtype).reshape(bshape)


def _gn_affine_flat(x: torch.Tensor, groups: int, scale: torch.Tensor, bias: torch.Tensor,
                    mean: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """GroupNorm with known global stats as a per-(B, channel) affine
    y = a·x + b, a = inv·γ, b = β − mean·a (fp32 coefficients cast to x's
    dtype). Matches _gn_normalize to within one reassociation."""
    C = x.shape[1]
    per = C // groups
    m = mean.repeat_interleave(per, dim=1).float()  # (B, C)
    iv = inv.repeat_interleave(per, dim=1).float()
    a = iv * scale.float()[None, :]
    b = bias.float()[None, :] - m * a
    bc = a.shape + (1,) * (x.dim() - 2)
    return x * a.to(x.dtype).reshape(bc) + b.to(x.dtype).reshape(bc)


def _stats_from_sums(s1: torch.Tensor, s2: torch.Tensor,
                     count: float) -> Tuple[torch.Tensor, torch.Tensor]:
    mean = s1 / count
    var = torch.clamp(s2 / count - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + 1e-5)


def _group_sums(h: torch.Tensor, groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(B, group) fp32 (Σ, Σ²) of an NCDHW slab: spatial axes first,
    then channels folded into groups."""
    B = h.shape[0]
    hf = h.float()
    cs1 = hf.sum(dim=(2, 3, 4))
    cs2 = (hf * hf).sum(dim=(2, 3, 4))
    return cs1.reshape(B, groups, -1).sum(-1), cs2.reshape(B, groups, -1).sum(-1)


def _fold_conv_gn(seg: Sequence[Tuple], stats: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                  batch: int, gn_fold: bool = True) -> Tuple[List[Tuple], List[Tuple]]:
    """Fold conv→gn pairs into one conv with stats-scaled weights.

    GroupNorm with known global stats is a per-(B, channel) affine
    y = a·h + b; when the conv output feeds the gn directly and B == 1 it
    commutes into the conv: the kernel's output channels scale by a and the
    bias becomes a·bias + b. That removes a whole-volume elementwise pass
    per GroupNorm. Returns (folded ops, stats of the gns that remain)."""
    out: List[Tuple] = []
    rem_stats: List[Tuple] = []
    gn_i = 0
    i = 0
    while i < len(seg):
        op = seg[i]
        if (op[0] == "conv" and batch == 1 and gn_fold and i + 1 < len(seg)
                and seg[i + 1][0] == "gn"):
            _, kernel, bias, stride = op
            _, groups, scale, gbias = seg[i + 1]
            mean, inv = stats[gn_i]
            gn_i += 1
            per_ch = kernel.shape[0] // groups
            m = mean.reshape(-1).repeat_interleave(per_ch).float()
            iv = inv.reshape(-1).repeat_interleave(per_ch).float()
            a = iv * scale.float()
            b = gbias.float() - m * a
            k2 = kernel.float() * a[:, None, None, None, None]
            b0 = bias.float() if bias is not None else 0.0
            out.append(("conv", k2, a * b0 + b, stride))
            i += 2
        elif op[0] == "gn":
            rem_stats.append(stats[gn_i])
            gn_i += 1
            out.append(op)
            i += 1
        else:
            out.append(op)
            i += 1
    return out, rem_stats


class _SourceGrad:
    """The gradient of a pass's source, summed slab by slab into one buffer.
    A narrow's own backward makes a zero tensor of the source's full size for
    every slab (4.3 GB for the 64-channel 256³ endpoint the detail chain
    stores at batch 2) and autograd adds them up; here each slab's gradient
    is added into its planes of one buffer, and the last slab's backward
    hands the buffer on."""

    def __init__(self, src: torch.Tensor, reads: int):
        self.shape, self.pending, self.buf = src.shape, reads, None


class _SlabRead(torch.autograd.Function):
    """src.narrow(2, start, length), its gradient summed through a
    _SourceGrad shared by the pass's slab reads."""

    @staticmethod
    def forward(ctx, src, start: int, length: int, acc: _SourceGrad):
        ctx.start, ctx.length, ctx.acc = start, length, acc
        return src.narrow(2, start, length)

    @staticmethod
    def backward(ctx, g):
        acc = ctx.acc
        if acc.buf is None:
            acc.buf = torch.zeros(acc.shape, dtype=g.dtype, device=g.device)
        acc.buf.narrow(2, ctx.start, ctx.length).add_(g)
        acc.pending -= 1
        if acc.pending:
            return None, None, None, None
        buf, acc.buf = acc.buf, None
        return buf, None, None, None


def _slab_of(src: torch.Tensor, s_lo: int, ext: int, acc: _SourceGrad) -> Slab:
    """The slab of `ext` planes starting at source plane `s_lo`: the part
    inside the source as a D-narrowed view (no copy), its gradient summed
    through `acc`."""
    a, b = max(s_lo, 0), min(s_lo + ext, src.shape[2])
    return _SlabRead.apply(src, a, max(b - a, 0), acc), a - s_lo, ext


def _run_prefix(slab: Slab, ops: Sequence[Tuple[Tuple, Optional[str]]],
                stats: List[Tuple[torch.Tensor, torch.Tensor]], dtype, lo: int, level_d: int,
                gn_fn=_gn_normalize, endpoint_sums: bool = False):
    """Evaluate `ops` on a slab whose first plane has global D-coordinate
    `lo` at a level `level_d` planes deep; k3 convs run VALID in D through
    the chain kernels with the valid-input-plane window [−lo, level_d − lo)
    (each conv zero-pads its own input, as the dense path does). `ops` pairs
    each op with the activation fused into it as a prologue (None if not).
    With `endpoint_sums` the last op (a k3 conv) also returns its per-channel
    (Σ, Σ²), and the result is (h, s1, s2). `stats` is indexed by GN ordinal."""
    h, q0, n = slab
    gn_i = 0
    res = None
    for i, (op, pro_act) in enumerate(ops):
        if op[0] == "conv":
            _, kernel, bias, stride = op
            if kernel.shape[-1] == 1:
                if pro_act is not None:
                    raise ValueError("an activation fuses only into a k3 conv")
                h = conv1x1_ncdhw(h, kernel, bias)
                continue
            vlo, vhi = max(-lo, q0), min(level_d - lo, q0 + h.shape[2])
            view = h.narrow(2, vlo - q0, max(vhi - vlo, 0))
            n = n - 2 if stride == 1 else (n - 1) // 2
            sums = endpoint_sums and i == len(ops) - 1
            res = conv3d_chain(view, kernel.to(dtype), bias, stride, vlo, n, sums, pro_act)
            h, q0 = (res[0] if sums else res), 0
            lo += 1  # first VALID output coordinate (the window centre for s2)
            if stride == 2:
                lo //= 2  # centre → output index (centres are even by slab alignment)
                level_d //= 2
        elif op[0] == "gn":
            _, groups, scale, bias = op
            mean, inv = stats[gn_i]
            gn_i += 1
            h = gn_fn(h, groups, scale, bias, mean, inv)
        else:
            h = _act(op[1], h)
    return res if endpoint_sums else h


def _run_prefix_flat(slab: Slab, seg: Sequence[Tuple],
                     stats: List[Tuple[torch.Tensor, torch.Tensor]], dtype, lo: int,
                     level_d: int, endpoint_sums: bool = False, act_fuse: bool = False):
    """The streamed body (JAX ``_run_prefix_flat``): _run_prefix with the
    GroupNorm as a per-channel affine and, with `act_fuse`, each activation
    that directly precedes a k3 conv fused into that conv's input load (the
    kernels' prologue; off by default in JAX, where it measured a net loss)."""
    ops: List[Tuple[Tuple, Optional[str]]] = []
    i = 0
    while i < len(seg):
        op = seg[i]
        if (act_fuse and op[0] == "act" and i + 1 < len(seg)
                and seg[i + 1][0] == "conv" and seg[i + 1][1].shape[-1] == 3):
            ops.append((seg[i + 1], op[1]))
            i += 2
        else:
            ops.append((op, None))
            i += 1
    return _run_prefix(slab, ops, stats, dtype, lo, level_d, gn_fn=_gn_affine_flat,
                       endpoint_sums=endpoint_sums)


def _slab_count(d_out: int, num_slabs: int) -> int:
    """num_slabs halved until it divides the output depth."""
    n = num_slabs
    while n > 1 and d_out % n:
        n //= 2
    return max(n, 1)


def _scan(body, n: int) -> List:
    """body(j) for j < n, each under a non-reentrant checkpoint while autograd
    records (``lax.scan(jax.checkpoint(body))``): a body's activations are
    recomputed in the backward instead of kept."""
    if not torch.is_grad_enabled():
        return [body(j) for j in range(n)]
    return [checkpoint(body, j, use_reentrant=False) for j in range(n)]


def chain_apply_slab(x: torch.Tensor, chain: Sequence[Tuple], num_slabs: int = 8,
                     dtype: torch.dtype | None = None) -> torch.Tensor:
    """Streaming evaluation with no stored endpoint (the 'recompute' impl):
    one stats pass per GroupNorm over the whole prefix, then the emit pass;
    no intermediate exceeds one D-slab (+ halo) of the volume."""
    dtype = dtype or x.dtype
    x = x.to(dtype)
    B = x.shape[0]

    def run_pass(upto: Optional[int], stats: List):
        end = len(chain) if upto is None else upto
        C_out, D_out, H_out, W_out = _level_shape(chain, end, x.shape)
        n = _slab_count(D_out, num_slabs)
        sd = D_out // n
        F_, c_lo, c_hi = _walk_back(chain, end)
        ext = F_ * sd + (c_hi - c_lo)
        seg, seg_stats = _fold_conv_gn(chain[:end], stats, B)
        ops = [(op, None) for op in seg]
        groups = chain[upto][1] if upto is not None else 1
        acc = _SourceGrad(x, n)

        def body(j):
            s_lo = j * F_ * sd + c_lo
            h = _run_prefix(_slab_of(x, s_lo, ext, acc), ops, seg_stats, dtype, s_lo,
                            x.shape[2])
            return h if upto is None else _group_sums(h, groups)

        outs = _scan(body, n)
        if upto is None:
            return torch.cat(outs, dim=2) if n > 1 else outs[0]
        s1 = torch.stack([o[0] for o in outs]).sum(0)
        s2 = torch.stack([o[1] for o in outs]).sum(0)
        return _stats_from_sums(s1, s2, float((C_out // groups) * D_out * H_out * W_out))

    stats: List = []
    for gi in (i for i, op in enumerate(chain) if op[0] == "gn"):
        stats.append(run_pass(gi, stats))
    return run_pass(None, stats)


def chain_apply_streamed(x: torch.Tensor, chain: Sequence[Tuple], num_slabs: int = 8,
                         dtype: torch.dtype | None = None, store_min_flops: float = 1e11,
                         dense_max_voxels: int = 129 ** 3, act_fuse: bool = False,
                         gn_fold: bool = True) -> torch.Tensor:
    """Streaming evaluation with endpoint storing (the 'streamed' impl):

      * one pass per GroupNorm, streaming from the nearest stored source,
        emitting its endpoint (the pre-GN activation) when worth storing and
        taking that GN's global (Σ, Σ²) from the endpoint conv's epilogue;
      * a pass whose segment holds ≥ `store_min_flops` of conv work stores
        its endpoint, so later passes read it instead of recomputing it
        (0.0 stores every endpoint: the eval schedule);
      * once every remaining level fits `dense_max_voxels` (after a stride-2
        conv drops 256³ → 128³) the rest runs dense.

    ``num_slabs == 1`` is the JAX static-slab branch: one body over the whole
    volume. `act_fuse` / `gn_fold`: the ``HVC_ACT_FUSE`` / ``HVC_GN_FOLD``
    switches of the JAX package, at its defaults."""
    dtype = dtype or x.dtype
    x = x.to(dtype)
    B = x.shape[0]
    n_ops = len(chain)
    gn_positions = [i for i, op in enumerate(chain) if op[0] == "gn"]
    stats_by_pos = {}

    def remaining_fits_dense(src_idx: int, src_shape) -> bool:
        levels = [_level_shape(chain, i, src_shape, start=src_idx)
                  for i in range(src_idx, n_ops + 1)]
        return all(D * H * W <= dense_max_voxels for (_, D, H, W) in levels)

    def stream_pass(src: torch.Tensor, src_idx: int, end: int, emit: bool, want_stats: bool):
        """Run chain[src_idx:end] slab-streamed over `src`; returns
        (endpoint | None, (mean, inv) | None)."""
        seg_stats = [stats_by_pos[p] for p in gn_positions if src_idx <= p < end]
        seg, seg_stats = _fold_conv_gn(chain[src_idx:end], seg_stats, B, gn_fold)
        C_out, D_out, H_out, W_out = _level_shape(chain, end, src.shape, start=src_idx)
        n = _slab_count(D_out, num_slabs)
        sd = D_out // n
        F_, c_lo, c_hi = _walk_back(chain, end, start=src_idx)
        ext = F_ * sd + (c_hi - c_lo)
        groups = chain[end][1] if want_stats else 1
        # the endpoint's stats come from the conv epilogue when the segment
        # ends in a k3 conv (it does at every GN boundary of the cascade)
        ksums = (want_stats and len(seg) > 0 and seg[-1][0] == "conv"
                 and seg[-1][1].shape[-1] == 3)
        acc = _SourceGrad(src, n)

        def body(j):
            s_lo = j * F_ * sd + c_lo
            res = _run_prefix_flat(_slab_of(src, s_lo, ext, acc), seg, seg_stats, dtype, s_lo,
                                   src.shape[2], endpoint_sums=ksums, act_fuse=act_fuse)
            if ksums:
                h, c1, c2 = res
                g1 = c1.reshape(B, groups, -1).sum(-1)
                g2 = c2.reshape(B, groups, -1).sum(-1)
            else:
                h = res
                g1, g2 = _group_sums(h, groups) if want_stats else (None, None)
            return (h if emit else None), g1, g2

        outs = _scan(body, n)
        out = None
        if emit:
            out = torch.cat([o[0] for o in outs], dim=2) if n > 1 else outs[0][0]
        st = None
        if want_stats:
            s1 = torch.stack([o[1] for o in outs]).sum(0)
            s2 = torch.stack([o[2] for o in outs]).sum(0)
            st = _stats_from_sums(s1, s2, float((C_out // groups) * D_out * H_out * W_out))
        return out, st

    src, src_idx = x, 0
    for b in gn_positions + [n_ops]:
        if remaining_fits_dense(src_idx, src.shape):
            return chain_apply_dense(src, list(chain[src_idx:]), dtype)
        is_final = b == n_ops
        store = is_final or _conv_flops(chain, src_idx, b, src.shape) >= store_min_flops
        out, st = stream_pass(src, src_idx, b, emit=store, want_stats=not is_final)
        if is_final:
            return out
        stats_by_pos[b] = st
        if store:
            src, src_idx = out, b
    raise AssertionError("unreachable")
