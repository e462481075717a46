"""The 3×3×3 conv and its gradients on the card, in one contract that covers
the dense (padding 1) conv and the slab-chain conv: ``conv3d_k3`` (forward),
``conv3d_k3_dgrad`` (data gradient), ``conv3d_k3_wgrad`` (weight gradient).

- Forward, ``csrc/conv3d_k3.cu`` (each stride in two instances, bf16 on the
  tensor cores and the rest on the CUDA cores): counterparts of
  ``_conv_fwd`` (``hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3.py``) and
  ``_conv_fwd_s2`` (``hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3s2.py``).
  Data gradient: at
  stride 1 the forward kernel on the output gradient with channel-
  transposed, tap-flipped weights (``conv3d_k3.py:650-652``); at stride 2
  ``_dgrad_s2`` (``csrc/conv3d_k3_bwd.cu``). Weight gradient: ``_wgrad`` and
  ``_wgrad_s2`` (``csrc/conv3d_k3_bwd.cu``).
- The kernel letters name what a call computes, and each has its own launch
  counter: with ``dense`` the padding-1 conv — B / C forward at stride 1 / 2,
  B as the stride-1 data gradient, F the stride-2 one, E / G the weight
  gradients; otherwise the chain forms of ``conv3d_k3s1_chain``
  (``conv3d_k3.py:662``) and ``conv3d_k3s2_chain`` (``conv3d_k3s2.py:602``)
  and their VJPs — H / I forward, H as the stride-1 data gradient, J the
  stride-2 one, K the weight gradients.

The contract. ``x`` is the part of a D-slab that lies inside the
valid-plane window: a (B, Cin, nv, H, W) tensor whose inner three dims are
contiguous (a D-narrowed view of a larger volume is taken as it is — no copy);
slab plane q is plane q − ``qlo`` of x, and every other slab plane reads as
zero (the dense path's per-conv zero padding). Output plane o reads slab planes
S·o + {0, 1, 2}; ``d_out`` output planes are computed. H and W are SAME. So
the dense conv is the chain conv with ``qlo = 1`` and ``d_out = ⌈D/S⌉``.
``act`` ('gelu' | 'silu' | None) applies the activation to x at the load
(fp32, rounded to x's dtype, as ``_pact``); ``want_sums`` also returns
per-(B, Cout) fp32 Σ and Σ² of the rounded output. The data gradients return
the gradient of x's planes only (the window's transpose) and, with ``act``,
multiply it by act′(x) (the act′ epilogue).

Every wrapper launches its CUDA kernel for tensors on a CUDA device and runs
its plain version for tensors on the CPU; for any other device it raises. It
never falls back from the kernel to the plain version. Each launch adds one
to its letter's counter in ``LAUNCHES`` (the stride-1 data gradient is
counted there, not under the forward). A call on a tensor-core instance also
adds one to that instance's counter: the conv at either stride and the
stride-1 data gradient (bf16, Cin ≥ 8 and Cout ≥ 8 as the kernel sees them:
the C rule, which ``fwd_uses_tensor_cores`` states for the CPU) to
``conv3d_k3s{1,2}_tc`` when dense and ``conv3d_k3s{1,2}_chain_tc`` otherwise,
the one-output-channel stride-1 call, that is the data gradient of a conv
with one input channel (bf16, 8 ≤ Cin ≤ 64 as the kernel sees them, no
prologue, no sums: ``dgrad_c1_uses_tensor_cores``), to
``conv3d_k3s1_dgrad_c1_tc`` when dense and ``conv3d_k3s1_chain_dgrad_c1_tc``
otherwise, the one-input-channel conv (bf16, Cin = 1, Cout ≥ 8, no act′
epilogue: ``fwd_c1in_uses_tensor_cores``), at stride 1 the forward of the
1→32 and 1→64 convs, to ``conv3d_k3s1_c1in_tc`` when dense and
``conv3d_k3s1_chain_c1in_tc`` otherwise, at stride 2 that of stage 1's 1→64
stem to ``conv3d_k3s2_c1in_tc`` (dense and chain), a weight gradient on the tensor cores (bf16, Cin ≥ 8: instance 1
of ``wgrad_instance``) to ``conv3d_k3s{1,2}_wgrad_tc`` and one with one input
channel (bf16: instance 2 at stride 1, 3 at stride 2) to
``conv3d_k3s{1,2}_wgrad_c1in_tc`` (dense and chain), the stride-2 data gradient on the tensor cores (bf16, Cin ≥ 8 and
Cout ≥ 8: instance 1 of ``dgrad_s2_instance``) to ``conv3d_k3s2_dgrad_tc``
when dense and ``conv3d_k3s2_chain_dgrad_tc`` otherwise, and one with one dx
channel (bf16, 8 ≤ Cout ≤ 64, no act′: instance 2), the data gradient of the
1→64 stem, to ``conv3d_k3s2_dgrad_c1in_tc`` (dense and chain), the same call in
fp32 (instance 3, its CUDA-core form) to ``conv3d_k3s2_dgrad_c1in_fp32``. The stride-2 kernels with one
input channel also count in ``conv3d_k3s2_c1in``, ``conv3d_k3s2_dgrad_c1in``
and ``conv3d_k3s2_wgrad_c1in``, whichever instance they take.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODES = {None: 0, "gelu": 1, "silu": 2}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# hvc_conv3d_k3s1_fwd(x, w, bias, out, B, cin, cout, nv, H, W, Do, qlo, xb, xc,
#                     act, dact, dact_x, db, dc, partial, sums, dtype, stream);
# hvc_conv3d_k3s2_fwd takes wtc (s2_tc_weights, or null) after w
_FWD_ARGTYPES = (_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _L, _L,
                 _I, _I, _P, _L, _L, _P, _P, _I, _P)
_FWD_S2_ARGTYPES = _FWD_ARGTYPES[:2] + (_P,) + _FWD_ARGTYPES[2:]
# hvc_conv3d_k3s{1,2}_wgrad(x, g, partial, out, B, cin, cout, nv, H, W, Do, qlo, xb, xc,
#                           act, dtype, splits, stream)
_WGRAD_ARGTYPES = (_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _L, _L, _I, _I, _I, _P)
# hvc_conv3d_k3s2_dgrad(g, w, wtc, dx, B, cin, cout, nv, H, W, Do, qlo, dact, dact_x, db,
#                       dc, dtype, stream); wtc: s2_dgrad_tc_weights, or null
_DGRAD_ARGTYPES = (_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _P, _L, _L, _I, _P)
# hvc_conv3d_k3_fwd_tc(stride, cin, cout, dtype): 1 if the forward takes the
# tensor cores
_FWD_TC_ARGTYPES = (_I, _I, _I, _I)
# hvc_conv3d_k3s1_c1_tc(cin, cout, act, sums, dtype): 1 if the stride-1 call
# takes the one-output-channel tensor-core instance
_C1_TC_ARGTYPES = (_I, _I, _I, _I, _I)
# hvc_conv3d_k3s{1,2}_c1in_tc(cin, cout, dact, dtype): 1 if the call takes the
# one-input-channel tensor-core instance
_C1IN_TC_ARGTYPES = (_I, _I, _I, _I)
# hvc_conv3d_k3s2_dgrad_tc(cin, cout, dact, dtype): the stride-2 data
# gradient's instance
_DGRAD_TC_ARGTYPES = (_I, _I, _I, _I)
# hvc_conv3d_k3_wgrad_tc(stride, cin, dtype): the weight gradient's instance
_WGRAD_TC_ARGTYPES = (_I, _I, _I)
# The forward's instances with Σ/Σ² (fwd_plan): 0 the CUDA cores, 1 the
# tensor cores (16-channel chunks), 2 the one-input-channel tensor cores.
FWD_CUDA_CORE, FWD_TC, FWD_C1IN_TC = 0, 1, 2
# Output voxels (D, H, W) per forward block of each instance, by stride
# (csrc/conv3d_k3.cu): the Σ/Σ² epilogue writes one partial per block and
# output channel (fwd_partial_blocks).
_FWD_TILE_TC = {1: (4, 4, 32), 2: (2, 4, 16)}
_FWD_TILE_C1IN = {1: (4, 4, 64), 2: (4, 4, 32)}
_FWD_TILE_CUDA_CORE = {1: (1, 8, 32), 2: (1, 8, 16)}
# The stride-2 tensor-core instance: output channels per block (M) and input
# channels per chunk (one k16 step a tap), the blocks of its weight layout
# (s2_tc_weights).
_S2_TC_CO = 64
_S2_TC_CI = 16
# The stride-2 data gradient's instances (csrc/conv3d_k3_bwd.cu, the codes of
# hvc_conv3d_k3s2_dgrad_tc): 0 the CUDA cores, 1 the tensor cores (Cin ≥ 8),
# 2 the one-dx-channel tensor cores (8 ≤ Cout ≤ DGRAD_C1_CO_MAX, the g
# channels a block holds), 3 their CUDA-core form in fp32. The tensor-core
# instance: dx channels per block (M) and output-gradient channels per chunk
# (one k16 step a tap), the blocks of its weight layout (s2_dgrad_tc_weights).
DGRAD_S2_CUDA_CORE, DGRAD_S2_TC, DGRAD_S2_C1_TC, DGRAD_S2_C1_FP32 = 0, 1, 2, 3
DGRAD_C1_CO_MAX = 64
_DGRAD_TC_CI = 32
_DGRAD_TC_CO = 16
# The weight gradient's instances (csrc/conv3d_k3_bwd.cu, the codes of
# hvc_conv3d_k3_wgrad_tc): 0 the CUDA cores, 1 the tensor cores (Cin ≥ 8),
# 2 the one-input-channel tensor cores (stride 1), 3 their stride-2 form,
# each blocked as (output voxels per tile (D, H, W), output and input
# channels per block, blocks per SM it aims for): the B·Do·Ho·Wo reduction is
# split into fp32 partials over the output tiles, one per block of (split,
# Cout tile, Cin chunk). The tensor-core instance holds 162 KB of shared
# memory (139 KB at stride 2), one block per SM; the one-input-channel one
# 73 KB, three (86 KB, two, at stride 2); the CUDA-core one takes 1 input
# channel a block when Cin < 4.
WGRAD_CUDA_CORE, WGRAD_TC, WGRAD_C1IN_TC, WGRAD_C1IN_S2_TC = 0, 1, 2, 3
_WGRAD_TC = {1: ((4, 4, 16), 32, 32, 1), 2: ((2, 2, 16), 32, 32, 1)}
_WGRAD_C1IN_TC = ((2, 2, 64), 32, 1, 3)
_WGRAD_C1IN_S2_TC = ((2, 4, 32), 32, 1, 2)
_WGRAD_CUDA_CORE = ((1, 8, 16), 32, 4, 8)


def _out_dims(dhw, stride: int) -> tuple[int, int, int]:
    return tuple((s - 1) // stride + 1 for s in dhw)


def _no_tf32(fn, *args, **kwargs):
    """Run a cuDNN call with TF32 off, so an fp32 reference is full fp32."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return fn(*args, **kwargs)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


# --------------------------------------------------------- plain versions ---

def act_plain(act: Optional[str], x: torch.Tensor) -> torch.Tensor:
    """The chain prologue: act(x) in fp32, rounded to x's dtype (``_pact``)."""
    if act is None:
        return x
    y = F.gelu(x.float()) if act == "gelu" else F.silu(x.float())
    return y.to(x.dtype)


def dact_plain(act: str, x: torch.Tensor) -> torch.Tensor:
    """act′(x) in fp32 (``_dact_f32``): the chain data gradient's epilogue."""
    xf = x.float()
    if act == "gelu":
        return 0.5 * (1.0 + torch.erf(xf * 0.7071067811865476)) + \
            xf * 0.3989422804014327 * torch.exp(-0.5 * xf * xf)
    s = torch.sigmoid(xf)
    return s * (1.0 + xf * (1.0 - s))


def _slab_plain(x: torch.Tensor, qlo: int, n: int, act: Optional[str]) -> torch.Tensor:
    """The n-plane fp32 D-slab of the chain contract: act(x) at planes
    [qlo, qlo + nv), zeros elsewhere."""
    B, C, nv, H, W = x.shape
    slab = x.new_zeros((B, C, n, H, W), dtype=torch.float32)
    lo, hi = max(qlo, 0), min(qlo + nv, n)
    if hi > lo:
        slab[:, :, lo:hi] = act_plain(act, x[:, :, lo - qlo:hi - qlo]).float()
    return slab


def conv3d_k3_plain(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                    stride: int, qlo: int, d_out: int, want_sums: bool = False,
                    act: Optional[str] = None):
    """The conv of the chain contract: mask the slab planes outside x,
    F.conv3d with padding (0, 1, 1) in fp32 (TF32 off), rounded to x's
    dtype; the sums are taken over the rounded output."""
    slab = _slab_plain(x, qlo, stride * (d_out - 1) + 3, act)
    b = None if bias is None else bias.float()
    out = _no_tf32(F.conv3d, slab, w.float(), b, stride=stride, padding=(0, 1, 1)).to(x.dtype)
    if not want_sums:
        return out
    of = out.float()
    return out, of.sum(dim=(2, 3, 4)), (of * of).sum(dim=(2, 3, 4))


def conv3d_k3_dgrad_plain(g: torch.Tensor, w: torch.Tensor, x: torch.Tensor, stride: int,
                          qlo: int, act: Optional[str] = None) -> torch.Tensor:
    """dx (x's shape, g's dtype) of the conv for output gradient g:
    torch.nn.grad.conv3d_input over the slab in fp32 (TF32 off), cut to x's
    planes, times act′(x) with ``act``."""
    B, cin, nv, H, W = x.shape
    n = stride * (g.shape[2] - 1) + 3
    full = _no_tf32(torch.nn.grad.conv3d_input, (B, cin, n, H, W), w.float(), g.float(),
                    stride=stride, padding=(0, 1, 1))
    dx = full.new_zeros((B, cin, nv, H, W))
    lo, hi = max(qlo, 0), min(qlo + nv, n)
    if hi > lo:
        dx[:, :, lo - qlo:hi - qlo] = full[:, :, lo:hi]
    if act is not None:
        dx = dx * dact_plain(act, x)
    return dx.to(g.dtype)


def conv3d_k3_wgrad_plain(x: torch.Tensor, g: torch.Tensor, stride: int, qlo: int,
                          act: Optional[str] = None) -> torch.Tensor:
    """dW (Cout, Cin, 3, 3, 3) fp32 of the conv: torch.nn.grad.conv3d_weight
    over the act-replayed slab in fp32 (TF32 off)."""
    slab = _slab_plain(x, qlo, stride * (g.shape[2] - 1) + 3, act)
    return _no_tf32(torch.nn.grad.conv3d_weight, slab, (g.shape[1], x.shape[1], 3, 3, 3),
                    g.float(), stride=stride, padding=(0, 1, 1))


# ---------------------------------------------------------------- checks ---

def _check_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"conv3d_k3 runs on cuda or cpu tensors, got {t.device}")


def _check_view(name: str, x: torch.Tensor, dtype: torch.dtype, device) -> None:
    """x (B, C, n, H, W) in `dtype` on `device` with contiguous (n, H, W)
    planes; its batch and channel strides are free (a D-narrowed view)."""
    if x.dtype not in _DTYPE_CODES or x.dtype != dtype:
        raise TypeError(f"{name} must be float32 or bfloat16 and match: {x.dtype} vs {dtype}")
    if x.dim() != 5:
        raise ValueError(f"{name} must be (B, C, D, H, W), got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    _, _, _, H, W = x.shape
    if x.stride(3) != W or x.stride(4) != 1 or (x.shape[2] > 1 and x.stride(2) != H * W):
        raise ValueError(f"{name} needs contiguous (D, H, W) planes, strides {x.stride()}")
    if max(x.shape[1:]) > 2**31 - 1:
        raise ValueError(f"dimension too large for the kernel: {tuple(x.shape)}")


def _check_weights(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    if w.dim() != 5 or tuple(w.shape[2:]) != (3, 3, 3) or w.shape[1] != x.shape[1]:
        raise ValueError(f"expected x (B, Cin, D, H, W) and w (Cout, Cin, 3, 3, 3); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.dtype != x.dtype:
        raise TypeError(f"w must be in x's dtype {x.dtype}, got {w.dtype}")
    if w.device != x.device or not w.is_contiguous():
        raise ValueError(f"w must be contiguous and on {x.device}")
    if bias is not None and (bias.dtype != torch.float32 or tuple(bias.shape) != (w.shape[0],)
                             or bias.device != x.device or not bias.is_contiguous()):
        raise ValueError(f"bias must be contiguous fp32 of shape ({w.shape[0]},) on "
                         f"{x.device}, got {bias.dtype} {tuple(bias.shape)}")


def _check_out_grad(g: torch.Tensor, shape) -> None:
    if tuple(g.shape) != tuple(shape):
        raise ValueError(f"g has shape {tuple(g.shape)}, expected {tuple(shape)}")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")


# ---------------------------------------------------------------- launches ---

def s2_tc_weights(w: torch.Tensor) -> torch.Tensor:
    """The weights (Cout, Cin, 3, 3, 3) in the stride-2 tensor-core
    instance's layout: (⌈Cout/64⌉, ⌈Cin/16⌉, 27 taps, 64 co, 16 ci),
    zero-padded, so the weights of a block's Cout tile and Cin chunk are one
    contiguous copy, [tap][co][ci] as the A operand's rows."""
    cout, cin = w.shape[:2]
    n_co, n_ci = -(-cout // _S2_TC_CO), -(-cin // _S2_TC_CI)
    wp = w.new_zeros((n_co * _S2_TC_CO, n_ci * _S2_TC_CI, 27))
    wp[:cout, :cin] = w.reshape(cout, cin, 27)
    return wp.view(n_co, _S2_TC_CO, n_ci, _S2_TC_CI, 27).permute(0, 2, 4, 1, 3).contiguous()


def _fwd(entry: str, stride: int, x: torch.Tensor, w: torch.Tensor,
         bias: Optional[torch.Tensor], qlo: int, d_out: int, want_sums: bool = False,
         act: Optional[str] = None, dact: Optional[tuple] = None, dense: bool = False):
    """Launch kernel B/C/H/I on the instance the C dispatch picks; returns out
    or (out, s1, s2). A tensor-core launch, by the C rules
    (``hvc_conv3d_k3_fwd_tc``, ``hvc_conv3d_k3s1_c1_tc``,
    ``hvc_conv3d_k3s{stride}_c1in_tc``), also counts in
    ``conv3d_k3s{stride}_tc``, with one output channel in
    ``conv3d_k3s1_dgrad_c1_tc``, with one input channel in
    ``conv3d_k3s{stride}_c1in_tc`` (``dense``; else their ``_chain`` forms,
    but at stride 2 ``conv3d_k3s2_c1in_tc`` counts both); at stride 2 the tensor-core instance reads the weights in
    ``s2_tc_weights``'s layout."""
    _check_cuda(x)
    _check_view("x", x, x.dtype, x.device)
    _check_weights(x, w, bias)
    if d_out < 1:
        raise ValueError(f"d_out must be ≥ 1, got {d_out}")
    if bias is None:
        bias = torch.zeros(w.shape[0], dtype=torch.float32, device=x.device)
    B, cin, nv, H, W = x.shape
    cout = w.shape[0]
    ho, wo = _out_dims((H, W), stride)
    out = torch.empty((B, cout, d_out, ho, wo), dtype=x.dtype, device=x.device)
    dact_code, dact_x, db, dc = 0, None, 0, 0
    if dact is not None:
        dact_x = dact[1]
        _check_view("dact x", dact_x, x.dtype, x.device)
        if tuple(dact_x.shape) != tuple(out.shape):
            raise ValueError(f"dact x {tuple(dact_x.shape)} must have the output's shape "
                             f"{tuple(out.shape)}")
        dact_code, db, dc = _ACT_CODES[dact[0]], dact_x.stride(0), dact_x.stride(1)
    partial = sums = None
    if want_sums:
        nblk = fwd_partial_blocks((B, cin, d_out, H, W), stride)
        partial = torch.empty((B * cout * nblk * 2,), dtype=torch.float32, device=x.device)
        sums = torch.empty((2, B, cout), dtype=torch.float32, device=x.device)
    tc = bool(_build.function("hvc_conv3d_k3_fwd_tc", _FWD_TC_ARGTYPES)(
        stride, cin, cout, _DTYPE_CODES[x.dtype]))
    c1 = stride == 1 and bool(_build.function("hvc_conv3d_k3s1_c1_tc", _C1_TC_ARGTYPES)(
        cin, cout, _ACT_CODES[act], int(want_sums), _DTYPE_CODES[x.dtype]))
    c1in = bool(_build.function(f"hvc_conv3d_k3s{stride}_c1in_tc", _C1IN_TC_ARGTYPES)(
        cin, cout, dact_code, _DTYPE_CODES[x.dtype]))
    weights = (w.data_ptr(),)
    if stride == 2:
        wtc = s2_tc_weights(w) if tc else None
        weights += (None if wtc is None else wtc.data_ptr(),)
    fn = _build.function(entry, _FWD_S2_ARGTYPES if stride == 2 else _FWD_ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), *weights, bias.data_ptr(), out.data_ptr(), B, cin, cout, nv,
                H, W, d_out, qlo, x.stride(0), x.stride(1), _ACT_CODES[act], dact_code,
                None if dact_x is None else dact_x.data_ptr(), db, dc,
                None if partial is None else partial.data_ptr(),
                None if sums is None else sums.data_ptr(), _DTYPE_CODES[x.dtype], stream)
    _build.check(rc, entry)
    if tc:
        LAUNCHES[f"conv3d_k3s{stride}{'' if dense else '_chain'}_tc"] += 1
    if c1:
        LAUNCHES[_counter("_dgrad_c1_tc", 1, dense)] += 1
    if c1in:
        LAUNCHES[_counter("_c1in_tc", 1, dense) if stride == 1 else "conv3d_k3s2_c1in_tc"] += 1
    if stride == 2 and cin == 1:
        LAUNCHES["conv3d_k3s2_c1in"] += 1
    return (out, sums[0], sums[1]) if want_sums else out


def fwd_uses_tensor_cores(dtype: torch.dtype, stride: int, cin: int, cout: int) -> bool:
    """Which instance of the conv forward a call takes (the stride-1 data
    gradient is the forward on g: Cin and Cout swapped), the rule of
    ``fwd_uses_tc`` (csrc/conv3d_k3.cu) for plans and tests on the CPU; on
    the card the wrapper reads the C rule itself: bf16 at stride 1 or 2 with
    Cin ≥ 8 and Cout ≥ 8 runs on the tensor cores; fp32 (TF32 would leave the
    fp32 tolerances) on the CUDA cores, the one-output-channel data gradient
    on the instance ``dgrad_c1_uses_tensor_cores`` names and the
    one-input-channel conv on the one ``fwd_c1in_uses_tensor_cores`` names."""
    return dtype == torch.bfloat16 and stride in (1, 2) and cin >= 8 and cout >= 8


def fwd_c1in_uses_tensor_cores(dtype: torch.dtype, stride: int, cin: int, cout: int,
                               dact: bool = False) -> bool:
    """Which instance a conv call with one input channel takes, the rule of
    ``c1in_uses_tc`` (csrc/conv3d_k3.cu), which the wrapper reads through
    ``hvc_conv3d_k3s{1,2}_c1in_tc``: bf16 at stride 1 or 2 with Cin = 1, Cout
    ≥ 8 and no act′ epilogue (``dact``: no call with one input channel on the
    main path has it) — the forward of the stage-3 chains' 1→32 and 1→64
    convs (``conv_c1in_tc_kernel``) and of stage 1's stride-2 1→64 stem
    (``conv_c1in_s2_tc_kernel``), with or without the prologue and Σ/Σ² —
    runs on the one-input-channel tensor-core instance, bound by writing its
    output; fp32 (TF32 would leave the fp32 tolerances), Cin 2-7 and a call
    with act′ on the CUDA cores."""
    return (dtype == torch.bfloat16 and stride in (1, 2) and cin == 1 and cout >= 8
            and not dact)


def dgrad_c1_uses_tensor_cores(dtype: torch.dtype, cin: int, cout: int,
                               act: Optional[str] = None, sums: bool = False) -> bool:
    """Which instance a stride-1 call with one output channel takes, the rule
    of ``c1_uses_tc`` (csrc/conv3d_k3.cu), which the wrapper reads through
    ``hvc_conv3d_k3s1_c1_tc``. Cin and Cout as the kernel sees them: for the
    data gradient of a conv with one input channel (the stage-3 chains' 1→32
    and 1→64 convs) Cin is g's channels and Cout = 1. bf16 with Cout = 1,
    8 ≤ Cin ≤ 64 (the channels a block holds) and neither a prologue nor Σ/Σ²
    (no data gradient has either) runs on the tensor cores
    (``conv_c1_tc_kernel``, bound by reading g); fp32 (TF32 would leave the
    fp32 tolerances) and the other channel counts on the CUDA cores."""
    return (dtype == torch.bfloat16 and cout == 1 and 8 <= cin <= 64 and act is None
            and not sums)


def fwd_plan(out_shape, cout: int, stride: int,
             dtype: torch.dtype) -> tuple[int, tuple[int, int, int], int]:
    """(instance, tile, blocks) of a forward call with Σ/Σ²; out_shape = (B,
    Cin, Do, H, W): output planes, input rows and columns. ``instance`` is
    FWD_TC (``fwd_uses_tensor_cores``), FWD_C1IN_TC
    (``fwd_c1in_uses_tensor_cores``) or FWD_CUDA_CORE, ``tile`` the output
    voxels (D, H, W) of one block and ``blocks`` the number of blocks per
    (batch, Cout tile), each of which writes one Σ/Σ² partial per output
    channel. A call with Σ/Σ² never takes the one-output-channel instance
    (``dgrad_c1_uses_tensor_cores``) and has no act′ epilogue, so the plan
    names one of these three."""
    cin = out_shape[1]
    if fwd_uses_tensor_cores(dtype, stride, cin, cout):
        instance, tile = FWD_TC, _FWD_TILE_TC[stride]
    elif fwd_c1in_uses_tensor_cores(dtype, stride, cin, cout):
        instance, tile = FWD_C1IN_TC, _FWD_TILE_C1IN[stride]
    else:
        instance, tile = FWD_CUDA_CORE, _FWD_TILE_CUDA_CORE[stride]
    return instance, tile, _fwd_blocks(out_shape, stride, tile)


def fwd_partial_blocks(out_shape, stride: int) -> int:
    """Σ/Σ² partials per (batch, output channel) that a forward call
    allocates: the largest of the instances' block counts at this stride, so
    the buffer holds the grid of whichever instance the C dispatch
    launches."""
    tiles = (_FWD_TILE_TC, _FWD_TILE_C1IN, _FWD_TILE_CUDA_CORE)
    return max(_fwd_blocks(out_shape, stride, t[stride]) for t in tiles if stride in t)


def _fwd_blocks(out_shape, stride: int, tile) -> int:
    do = out_shape[2]
    ho, wo = _out_dims(out_shape[3:], stride)
    td, th, tw = tile
    return -(-do // td) * -(-ho // th) * -(-wo // tw)


def _wgrad(entry: str, stride: int, x: torch.Tensor, g: torch.Tensor, qlo: int,
           act: Optional[str] = None) -> torch.Tensor:
    """Launch kernel E/G/K: dW fp32 of the (chain) conv of x for g, on the
    instance the C rule names (``hvc_conv3d_k3_wgrad_tc``), split as
    ``wgrad_plan`` plans that instance; a launch on the tensor cores also
    counts in ``conv3d_k3s{stride}_wgrad_tc``, one on the one-input-channel
    instance in ``conv3d_k3s{stride}_wgrad_c1in_tc``."""
    _check_cuda(x)
    _check_view("x", x, g.dtype, g.device)
    B, cin, nv, H, W = x.shape
    cout, d_out = g.shape[1], g.shape[2]
    _check_out_grad(g, (B, cout, d_out, *_out_dims((H, W), stride)))
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    instance = _build.function("hvc_conv3d_k3_wgrad_tc", _WGRAD_TC_ARGTYPES)(
        stride, cin, _DTYPE_CODES[x.dtype])
    splits, _ = _wgrad_splits(instance, (B, cin, d_out, H, W), cout, stride, sms)
    partial = torch.empty((splits, cout, cin, 27), dtype=torch.float32, device=x.device)
    out = torch.empty((cout, cin, 3, 3, 3), dtype=torch.float32, device=x.device)
    fn = _build.function(entry, _WGRAD_ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), g.data_ptr(), partial.data_ptr(), out.data_ptr(), B, cin, cout,
                nv, H, W, d_out, qlo, x.stride(0), x.stride(1), _ACT_CODES[act],
                _DTYPE_CODES[x.dtype], splits, stream)
    _build.check(rc, entry)
    if instance == WGRAD_TC:
        LAUNCHES[f"conv3d_k3s{stride}_wgrad_tc"] += 1
    elif instance in (WGRAD_C1IN_TC, WGRAD_C1IN_S2_TC):
        LAUNCHES[f"conv3d_k3s{stride}_wgrad_c1in_tc"] += 1
    if stride == 2 and cin == 1:
        LAUNCHES["conv3d_k3s2_wgrad_c1in"] += 1
    return out


def wgrad_instance(dtype: torch.dtype, stride: int, cin: int) -> int:
    """Which instance of the weight gradient a call takes, the rule of
    ``wgrad_instance`` (csrc/conv3d_k3_bwd.cu) for plans and tests on the CPU;
    on the card the wrapper reads the C rule itself
    (``hvc_conv3d_k3_wgrad_tc``): WGRAD_TC, bf16 with Cin ≥ 8; WGRAD_C1IN_TC,
    bf16 at stride 1 with Cin = 1 (the stage-3 chains' 1→32 and 1→64 convs,
    bound by reading g); WGRAD_C1IN_S2_TC, bf16 at stride 2 with Cin = 1
    (stage 1's 1→64 stem, likewise); WGRAD_CUDA_CORE, fp32 (TF32 would leave
    the fp32 tolerances) and Cin 2-7."""
    if dtype != torch.bfloat16:
        return WGRAD_CUDA_CORE
    if cin >= 8:
        return WGRAD_TC
    if cin != 1:
        return WGRAD_CUDA_CORE
    return WGRAD_C1IN_TC if stride == 1 else WGRAD_C1IN_S2_TC


def split_tiles(n_tiles: int, blocks: int) -> tuple[int, int]:
    """(splits, per): split s takes tiles s·per … min(n, (s + 1)·per) − 1, about
    ``blocks`` splits, none of them empty."""
    per = -(-n_tiles // max(1, min(n_tiles, blocks)))
    return -(-n_tiles // per), per


def wgrad_blocking(instance: int, stride: int, cin: int):
    """(tile (D, H, W), Cout per block, Cin per block, blocks per SM) of a
    weight-gradient instance."""
    if instance == WGRAD_TC:
        return _WGRAD_TC[stride]
    if instance == WGRAD_C1IN_TC:
        return _WGRAD_C1IN_TC
    if instance == WGRAD_C1IN_S2_TC:
        return _WGRAD_C1IN_S2_TC
    tile, co_blk, ci_blk, per_sm = _WGRAD_CUDA_CORE
    return tile, co_blk, 1 if cin < 4 else ci_blk, per_sm


def _wgrad_splits(instance: int, out_shape, cout: int, stride: int, sms: int) -> tuple[int, int]:
    b, cin, do = out_shape[:3]
    ho, wo = _out_dims(out_shape[3:], stride)
    (td, th, tw), co_blk, ci_blk, per_sm = wgrad_blocking(instance, stride, cin)
    n_tiles = b * -(-do // td) * -(-ho // th) * -(-wo // tw)
    groups = -(-cout // co_blk) * -(-cin // ci_blk)
    return split_tiles(n_tiles, max(1, per_sm * sms // groups))[0], n_tiles


def wgrad_plan(out_shape, cout: int, stride: int, dtype: torch.dtype,
               sms: int) -> tuple[int, int, int]:
    """(instance, splits, tiles) of a weight-gradient call on a card with
    ``sms`` SMs; out_shape = (B, Cin, Do, H, W): output planes, input rows and
    columns; ``instance`` as ``wgrad_instance``. Each tile goes to one split,
    none is empty, and the blocks (splits × Cout tiles × Cin chunks) aim for
    the instance's blocks per SM (``wgrad_blocking``): on the CUDA cores
    split s takes a contiguous range (``split_tiles``), on either tensor-core
    instance the tiles s, s + splits, s + 2·splits, …"""
    instance = wgrad_instance(dtype, stride, out_shape[1])
    return (instance, *_wgrad_splits(instance, out_shape, cout, stride, sms))


def s2_dgrad_tc_weights(w: torch.Tensor) -> torch.Tensor:
    """The weights (Cout, Cin, 3, 3, 3) in the stride-2 data gradient's
    tensor-core layout: (⌈Cin/32⌉, ⌈Cout/16⌉, 27 taps, 32 ci, 16 co),
    zero-padded, so the weights of a block's Cin tile and Cout chunk are one
    contiguous copy, [tap][ci][co] as the A operand's rows."""
    cout, cin = w.shape[:2]
    n_ci, n_co = -(-cin // _DGRAD_TC_CI), -(-cout // _DGRAD_TC_CO)
    wp = w.new_zeros((n_co * _DGRAD_TC_CO, n_ci * _DGRAD_TC_CI, 27))
    wp[:cout, :cin] = w.reshape(cout, cin, 27)
    return wp.view(n_co, _DGRAD_TC_CO, n_ci, _DGRAD_TC_CI, 27).permute(2, 0, 4, 3, 1).contiguous()


def dgrad_s2_instance(dtype: torch.dtype, cin: int, cout: int, dact: bool = False) -> int:
    """Which instance of the stride-2 data gradient (F/J) a call takes, the
    rule of ``dgrad_s2_instance`` (csrc/conv3d_k3_bwd.cu), which the wrapper
    reads through ``hvc_conv3d_k3s2_dgrad_tc``; Cin and Cout are the conv's
    (dx's and g's channels): DGRAD_S2_TC, bf16 with Cin ≥ 8 and Cout ≥ 8;
    DGRAD_S2_C1_TC, bf16 with Cin = 1, 8 ≤ Cout ≤ 64 and no act′ epilogue
    (``dact``) — the data gradient of stage 1's 1→64 stem, bound by reading g
    (``dgrad_s2_c1_tc_kernel``: the taps as M); DGRAD_S2_C1_FP32, the same
    call in fp32 (``dgrad_s2_c1_f32_kernel``: that kernel's walk with the
    products in fp32 FMAs, TF32 being outside the fp32 tolerances);
    DGRAD_S2_CUDA_CORE, the rest of fp32 and of bf16."""
    c1 = cin == 1 and 8 <= cout <= DGRAD_C1_CO_MAX and not dact
    if dtype != torch.bfloat16:
        return DGRAD_S2_C1_FP32 if c1 else DGRAD_S2_CUDA_CORE
    if cin >= 8 and cout >= 8:
        return DGRAD_S2_TC
    return DGRAD_S2_C1_TC if c1 else DGRAD_S2_CUDA_CORE


def _dgrad_s2(g: torch.Tensor, w: torch.Tensor, x_shape, qlo: int,
              dact: Optional[tuple] = None, dense: bool = False) -> torch.Tensor:
    """Launch kernel F/J: dx (x_shape) of the stride-2 (chain) conv, on the
    instance the C rule names (``hvc_conv3d_k3s2_dgrad_tc``); a launch on the
    tensor cores also counts in ``conv3d_k3s2_dgrad_tc`` (``dense``) or
    ``conv3d_k3s2_chain_dgrad_tc`` and reads the weights in
    ``s2_dgrad_tc_weights``'s layout, one on the one-dx-channel tensor cores
    in ``conv3d_k3s2_dgrad_c1in_tc`` (dense and chain), one on their fp32
    form in ``conv3d_k3s2_dgrad_c1in_fp32``."""
    _check_cuda(g)
    _check_view("g", g, g.dtype, g.device)
    B, cin, nv, H, W = x_shape
    cout, d_out = w.shape[0], g.shape[2]
    if tuple(w.shape) != (cout, cin, 3, 3, 3) or not w.is_contiguous() or w.device != g.device:
        raise ValueError(f"w {tuple(w.shape)} does not fit x {tuple(x_shape)}")
    if w.dtype != g.dtype:
        raise TypeError(f"w must be in g's dtype {g.dtype}, got {w.dtype}")
    _check_out_grad(g, (B, cout, d_out, *_out_dims((H, W), 2)))
    dx = torch.empty(tuple(x_shape), dtype=g.dtype, device=g.device)
    if nv == 0:
        return dx
    dact_code, dact_x, db, dc = 0, None, 0, 0
    if dact is not None:
        dact_x = dact[1]
        _check_view("dact x", dact_x, g.dtype, g.device)
        if tuple(dact_x.shape) != tuple(x_shape):
            raise ValueError(f"dact x {tuple(dact_x.shape)} must have x's shape {tuple(x_shape)}")
        dact_code, db, dc = _ACT_CODES[dact[0]], dact_x.stride(0), dact_x.stride(1)
    instance = _build.function("hvc_conv3d_k3s2_dgrad_tc", _DGRAD_TC_ARGTYPES)(
        cin, cout, dact_code, _DTYPE_CODES[g.dtype])
    wtc = s2_dgrad_tc_weights(w) if instance == DGRAD_S2_TC else None
    fn = _build.function("hvc_conv3d_k3s2_dgrad", _DGRAD_ARGTYPES)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = fn(g.data_ptr(), w.data_ptr(), None if wtc is None else wtc.data_ptr(),
                dx.data_ptr(), B, cin, cout, nv, H, W, d_out, qlo, dact_code,
                None if dact_x is None else dact_x.data_ptr(), db, dc, _DTYPE_CODES[g.dtype],
                stream)
    _build.check(rc, "hvc_conv3d_k3s2_dgrad")
    if instance == DGRAD_S2_TC:
        LAUNCHES[_counter("_dgrad_tc", 2, dense)] += 1
    elif instance == DGRAD_S2_C1_TC:
        LAUNCHES["conv3d_k3s2_dgrad_c1in_tc"] += 1
    elif instance == DGRAD_S2_C1_FP32:
        LAUNCHES["conv3d_k3s2_dgrad_c1in_fp32"] += 1
    if cin == 1:
        LAUNCHES["conv3d_k3s2_dgrad_c1in"] += 1
    return dx


# ---------------------------------------------------------------- wrappers ---

def _counter(kind: str, stride: int, dense: bool) -> str:
    """The launch counter of a kernel: B-G for a dense call, H-K for a chain
    call (module docstring)."""
    return f"conv3d_k3s{stride}{'' if dense else '_chain'}{kind}"


def _check_dense(x_shape, stride: int, qlo: int, d_out: int, want_sums: bool,
                 act: Optional[str]) -> None:
    """A dense call is the chain call over the whole volume: offset 1, every
    output plane, no options."""
    if qlo != 1 or d_out != (x_shape[2] - 1) // stride + 1 or want_sums or act is not None:
        raise ValueError(f"a dense conv takes qlo 1, d_out ⌈D/{stride}⌉ and no options; got "
                         f"x {tuple(x_shape)}, qlo {qlo}, d_out {d_out}, sums {want_sums}, "
                         f"act {act}")


def conv3d_k3(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], stride: int,
              qlo: int, d_out: int, want_sums: bool = False, act: Optional[str] = None, *,
              dense: bool = False):
    """The 3×3×3 conv of the chain contract (module docstring) → out
    (B, Cout, d_out, ⌈H/S⌉, ⌈W/S⌉), or (out, s1, s2) with ``want_sums``.
    Kernel B / C at stride 1 / 2 with ``dense`` (the padding-1 conv: qlo 1,
    d_out ⌈D/S⌉, no options), H / I otherwise; bf16 with Cin ≥ 8 and Cout ≥ 8
    on the tensor cores (``fwd_uses_tensor_cores``), bf16 with Cin = 1 and
    Cout ≥ 8 on the one-input-channel tensor cores
    (``fwd_c1in_uses_tensor_cores``), the rest on the CUDA cores."""
    if dense:
        _check_dense(x.shape, stride, qlo, d_out, want_sums, act)
    if x.device.type == "cpu":
        return conv3d_k3_plain(x, w, bias, stride, qlo, d_out, want_sums, act)
    res = _fwd(f"hvc_conv3d_k3s{stride}_fwd", stride, x, w, bias, qlo, d_out, want_sums, act,
               dense=dense)
    LAUNCHES[_counter("", stride, dense)] += 1
    return res


def conv3d_k3_dgrad(g: torch.Tensor, w: torch.Tensor, x: torch.Tensor, stride: int, qlo: int,
                    act: Optional[str] = None, *, dense: bool = False) -> torch.Tensor:
    """dx (x's shape, g's dtype) of ``conv3d_k3(x, w, ·, stride, qlo, ...)``
    for output gradient g, times act′(x) with ``act`` (x is read only then).
    Stride 1: kernel B (``dense``) / H on g with channel-transposed,
    tap-flipped weights, as ``conv3d_k3.py:650-652`` (dx plane p reads g
    planes p + qlo − 2 + {0, 1, 2}, the vp=2 virtual padding of
    ``conv3d_k3.py:714``), on the instance ``fwd_uses_tensor_cores`` names
    for that call (its Cin is g's channels). Stride 2: kernel F (``dense``) /
    J, on the instance ``dgrad_s2_instance`` names. The data gradient
    of a conv with one input channel (g's channels to one) takes the instance
    ``dgrad_c1_uses_tensor_cores`` names."""
    if dense:
        _check_dense(x.shape, stride, qlo, g.shape[2], False, act)
    if g.device.type == "cpu":
        return conv3d_k3_dgrad_plain(g, w, x, stride, qlo, act)
    _check_view("x", x, g.dtype, g.device)
    dact = None if act is None else (act, x)
    if x.shape[2] == 0:
        return torch.empty(x.shape, dtype=g.dtype, device=g.device)
    if stride == 1:
        wt = w.transpose(0, 1).flip(2, 3, 4).contiguous()
        dx = _fwd("hvc_conv3d_k3s1_fwd", 1, g, wt, None, 2 - qlo, x.shape[2], dact=dact,
                  dense=dense)
    else:
        dx = _dgrad_s2(g, w, tuple(x.shape), qlo, dact=dact, dense=dense)
    LAUNCHES[_counter("_dgrad", stride, dense)] += 1
    return dx


def conv3d_k3_wgrad(x: torch.Tensor, g: torch.Tensor, stride: int, qlo: int,
                    act: Optional[str] = None, *, dense: bool = False) -> torch.Tensor:
    """dW (Cout, Cin, 3, 3, 3) fp32 of ``conv3d_k3(x, ·, ·, stride, qlo, ...)``
    for output gradient g, the prologue replayed: kernel E / G at stride 1 / 2
    with ``dense``, K otherwise; bf16 with Cin ≥ 8 on the tensor cores, bf16
    with Cin = 1 on the one-input-channel tensor cores (at stride 1 or 2), the
    rest on the CUDA cores (``wgrad_instance``)."""
    if dense:
        _check_dense(x.shape, stride, qlo, g.shape[2], False, act)
    if x.device.type == "cpu":
        return conv3d_k3_wgrad_plain(x, g, stride, qlo, act)
    out = _wgrad(f"hvc_conv3d_k3s{stride}_wgrad", stride, x, g, qlo, act)
    LAUNCHES[_counter("_wgrad", stride, dense)] += 1
    return out


# Kernel launches per counter since the last reset (ops.cuda.launch_counts):
# one per kernel letter; conv3d_k3s1_tc and conv3d_k3s1_chain_tc, the
# launches of B and H (forward and data gradient) that took the tensor-core
# instance; conv3d_k3s2_tc and conv3d_k3s2_chain_tc, those of C and I;
# conv3d_k3s{1,2}_wgrad_tc, those of E, G and K (dense and chain);
# conv3d_k3s2_dgrad_tc and conv3d_k3s2_chain_dgrad_tc, those of F and J;
# conv3d_k3s1_dgrad_c1_tc and conv3d_k3s1_chain_dgrad_c1_tc, those of B and H
# with one output channel (the data gradient of a 1-channel conv) on the
# one-output-channel tensor-core instance; conv3d_k3s1_c1in_tc and
# conv3d_k3s1_chain_c1in_tc, those of B and H with one input channel (the
# forward of the 1→32 and 1→64 convs) on the one-input-channel tensor-core
# instance, and conv3d_k3s2_c1in_tc those of C and I (the 1→64 stem);
# conv3d_k3s1_wgrad_c1in_tc, those of E and K at stride 1 with one input
# channel on the one-input-channel weight gradient, conv3d_k3s2_wgrad_c1in_tc
# those of G and K at stride 2 (the 1→64 stem); conv3d_k3s2_dgrad_c1in_tc,
# those of F and J with one dx channel on the one-dx-channel tensor cores,
# conv3d_k3s2_dgrad_c1in_fp32 those on its fp32 form;
# conv3d_k3s2_c1in, conv3d_k3s2_dgrad_c1in and conv3d_k3s2_wgrad_c1in, those
# of C/I, F/J and G/K at stride 2 with one input channel (the 1→64 stem),
# whichever instance they take.
LAUNCHES = {**{_counter(kind, s, dense): 0
               for dense in (True, False) for kind in ("", "_dgrad", "_wgrad") for s in (1, 2)},
            "conv3d_k3s1_tc": 0, "conv3d_k3s1_chain_tc": 0,
            "conv3d_k3s1_dgrad_c1_tc": 0, "conv3d_k3s1_chain_dgrad_c1_tc": 0,
            "conv3d_k3s1_c1in_tc": 0, "conv3d_k3s1_chain_c1in_tc": 0,
            "conv3d_k3s2_c1in_tc": 0, "conv3d_k3s2_dgrad_c1in_tc": 0,
            "conv3d_k3s2_dgrad_c1in_fp32": 0,
            "conv3d_k3s1_wgrad_c1in_tc": 0, "conv3d_k3s2_wgrad_c1in_tc": 0,
            "conv3d_k3s2_c1in": 0, "conv3d_k3s2_dgrad_c1in": 0,
            "conv3d_k3s2_wgrad_c1in": 0,
            "conv3d_k3s2_tc": 0, "conv3d_k3s2_chain_tc": 0,
            "conv3d_k3s1_wgrad_tc": 0, "conv3d_k3s2_wgrad_tc": 0,
            "conv3d_k3s2_dgrad_tc": 0, "conv3d_k3s2_chain_dgrad_tc": 0}
