"""The 3×3×3 conv (padding 1) and its gradients on the card.

- Kernels B and C, forward at stride 1 and 2 (``csrc/conv3d_k3.cu``):
  counterparts of ``hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3.py``
  (``_conv_fwd``) and ``hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3s2.py``
  (``_conv_fwd_s2``). Semantics: ``F.conv3d(x, w, b, stride, padding=1)`` on
  NCDHW input, OIDHW weights, fp32 bias and accumulation, output in x's dtype.
- The stride-1 data gradient is kernel B on the output gradient with
  channel-transposed, tap-flipped weights (``conv3d_k3.py:650-652``):
  ``conv3d_k3s1_dgrad``.
- Kernels E and G, the weight gradients at stride 1 and 2, and kernel F, the
  stride-2 data gradient (``csrc/conv3d_k3_bwd.cu``): counterparts of
  ``_wgrad`` (``conv3d_k3.py``), ``_wgrad_s2`` and ``_dgrad_s2``
  (``conv3d_k3s2.py``). Semantics: ``torch.nn.grad.conv3d_weight`` (fp32
  out) and ``torch.nn.grad.conv3d_input`` (x's dtype out).

Every wrapper launches its CUDA kernel for tensors on a CUDA device and runs
its plain version for tensors on the CPU; for any other device it raises. It
never falls back from the kernel to the plain version. Each counts its
kernel launches in ``.launches`` (the stride-1 data gradient counts its
launches of kernel B in its own ``.launches``, not in ``conv3d_k3s1``'s).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
)


def conv3d_k3_plain(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                    stride: int) -> torch.Tensor:
    """F.conv3d in fp32 on x's values, rounded to x's dtype. On a CUDA tensor
    cuDNN runs with TF32 off (torch.backends.cudnn.allow_tf32 = False for the
    call), so the reference is full fp32."""
    b = None if bias is None else bias.float()
    return _no_tf32(F.conv3d, x.float(), w.float(), b, stride=stride, padding=1).to(x.dtype)


_WGRAD_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)
_DGRAD_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
)
# Blocks the weight-gradient kernels aim for (8 per SM of an H100's 132): the
# B·D·H·W reduction is split into that many fp32 partials over the output
# tiles (csrc/conv3d_k3_bwd.cu: 8×16 output voxels per tile, 32 output and 4
# input channels per block, 1 input channel when Cin < 4).
_WGRAD_BLOCKS = 1056


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


def _check(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"conv3d_k3 takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[2:]) != (3, 3, 3) or w.shape[1] != x.shape[1]:
        raise ValueError(f"expected x (B, Cin, D, H, W) and w (Cout, Cin, 3, 3, 3); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.dtype != x.dtype:
        raise TypeError(f"w must be in x's dtype {x.dtype}, got {w.dtype}")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (w.shape[0],):
        raise ValueError(f"bias must be fp32 of shape ({w.shape[0]},), got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    for name, t in (("w", w), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("w", w), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(x.shape[1:]) > 2**31 - 1:
        raise ValueError(f"dimension too large for the kernel: {tuple(x.shape)}")


def _launch(entry: str, stride: int, x: torch.Tensor, w: torch.Tensor,
            bias: Optional[torch.Tensor]) -> torch.Tensor:
    if x.device.type != "cuda":
        raise RuntimeError(f"conv3d_k3 runs on cuda or cpu tensors, got {x.device}")
    if bias is None:
        bias = torch.zeros(w.shape[0], dtype=torch.float32, device=x.device)
    _check(x, w, bias)
    B, cin, D, H, W = x.shape
    cout = w.shape[0]
    out = torch.empty((B, cout, (D - 1) // stride + 1, (H - 1) // stride + 1,
                       (W - 1) // stride + 1), dtype=x.dtype, device=x.device)
    fn = _build.function(entry, _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                B, cin, cout, D, H, W, _DTYPE_CODES[x.dtype], stream)
    _build.check(rc, entry)
    return out


def conv3d_k3s1(x: torch.Tensor, w: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3×3×3 conv, stride 1, padding 1: (B, Cin, D, H, W) → (B, Cout, D, H, W)."""
    if x.device.type == "cpu":
        return conv3d_k3_plain(x, w, bias, 1)
    out = _launch("hvc_conv3d_k3s1_fwd", 1, x, w, bias)
    conv3d_k3s1.launches += 1
    return out


def conv3d_k3s2(x: torch.Tensor, w: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3×3×3 conv, stride 2, padding 1: (B, Cin, D, H, W) →
    (B, Cout, ⌈D/2⌉, ⌈H/2⌉, ⌈W/2⌉)."""
    if x.device.type == "cpu":
        return conv3d_k3_plain(x, w, bias, 2)
    out = _launch("hvc_conv3d_k3s2_fwd", 2, x, w, bias)
    conv3d_k3s2.launches += 1
    return out


conv3d_k3s1.launches = 0
conv3d_k3s2.launches = 0


# ------------------------------------------------------------- gradients ---

def conv3d_k3_wgrad_plain(x: torch.Tensor, g: torch.Tensor, stride: int) -> torch.Tensor:
    """dW (Cout, Cin, 3, 3, 3) fp32 of F.conv3d(x, w, stride, padding=1) for
    output gradient g: torch.nn.grad.conv3d_weight in fp32 (TF32 off)."""
    shape = (g.shape[1], x.shape[1], 3, 3, 3)
    return _no_tf32(torch.nn.grad.conv3d_weight, x.float(), shape, g.float(),
                    stride=stride, padding=1)


def conv3d_k3_dgrad_plain(g: torch.Tensor, w: torch.Tensor, x_shape, stride: int) -> torch.Tensor:
    """dx of F.conv3d(x, w, stride, padding=1) for output gradient g:
    torch.nn.grad.conv3d_input in fp32 (TF32 off), rounded to g's dtype."""
    return _no_tf32(torch.nn.grad.conv3d_input, tuple(x_shape), w.float(), g.float(),
                    stride=stride, padding=1).to(g.dtype)


def _check_grad(x_shape, g: torch.Tensor, stride: int, cout: int, *others) -> None:
    if g.dtype not in _DTYPE_CODES:
        raise TypeError(f"conv3d_k3 gradients take float32 or bfloat16, got {g.dtype}")
    if len(x_shape) != 5 or g.dim() != 5:
        raise ValueError(f"expected 5-D x and g, got {tuple(x_shape)} and {tuple(g.shape)}")
    want = (x_shape[0], cout, *_out_dims(x_shape[2:], stride))
    if tuple(g.shape) != want:
        raise ValueError(f"g has shape {tuple(g.shape)}, the conv of {tuple(x_shape)} gives {want}")
    for name, t in (("g", g),) + others:
        if t.dtype != g.dtype or t.device != g.device:
            raise ValueError(f"{name} must match g in dtype and device: {t.dtype}/{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(x_shape[1:]) > 2**31 - 1:
        raise ValueError(f"dimension too large for the kernel: {tuple(x_shape)}")


def _wgrad_splits(x_shape, cout: int, stride: int) -> int:
    """Number of partial sums of the B·D·H·W reduction (see _WGRAD_BLOCKS)."""
    b, cin = x_shape[:2]
    do, ho, wo = _out_dims(x_shape[2:], stride)
    n_tiles = b * do * -(-ho // 8) * -(-wo // 16)
    groups = -(-cout // 32) * -(-cin // (1 if cin < 4 else 4))
    return max(1, min(n_tiles, -(-_WGRAD_BLOCKS // groups)))


def _wgrad(entry: str, stride: int, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cuda":
        raise RuntimeError(f"conv3d_k3 runs on cuda or cpu tensors, got {x.device}")
    cout = g.shape[1]
    _check_grad(x.shape, g, stride, cout, ("x", x))
    B, cin, D, H, W = x.shape
    splits = _wgrad_splits(x.shape, cout, stride)
    partial = torch.empty((splits, cout, cin, 27), dtype=torch.float32, device=x.device)
    out = torch.empty((cout, cin, 3, 3, 3), dtype=torch.float32, device=x.device)
    fn = _build.function(entry, _WGRAD_ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), g.data_ptr(), partial.data_ptr(), out.data_ptr(),
                B, cin, cout, D, H, W, _DTYPE_CODES[x.dtype], splits, stream)
    _build.check(rc, entry)
    return out


def conv3d_k3s1_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Kernel E: dW (Cout, Cin, 3, 3, 3) fp32 of the stride-1 conv of x
    (B, Cin, D, H, W) for output gradient g (B, Cout, D, H, W), same dtype."""
    if x.device.type == "cpu":
        return conv3d_k3_wgrad_plain(x, g, 1)
    out = _wgrad("hvc_conv3d_k3s1_wgrad", 1, x, g)
    conv3d_k3s1_wgrad.launches += 1
    return out


def conv3d_k3s2_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Kernel G: dW (Cout, Cin, 3, 3, 3) fp32 of the stride-2 conv of x
    (B, Cin, D, H, W) for output gradient g (B, Cout, ⌈D/2⌉, ⌈H/2⌉, ⌈W/2⌉)."""
    if x.device.type == "cpu":
        return conv3d_k3_wgrad_plain(x, g, 2)
    out = _wgrad("hvc_conv3d_k3s2_wgrad", 2, x, g)
    conv3d_k3s2_wgrad.launches += 1
    return out


def conv3d_k3s1_dgrad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx of the stride-1 conv: kernel B on g (B, Cout, D, H, W) with the
    weights channel-transposed and tap-flipped, as conv3d_k3.py:650-652 does.
    w (Cout, Cin, 3, 3, 3) in g's dtype; returns (B, Cin, D, H, W)."""
    if g.device.type == "cpu":
        return conv3d_k3_dgrad_plain(g, w, (g.shape[0], w.shape[1], *g.shape[2:]), 1)
    wt = w.transpose(0, 1).flip(2, 3, 4).contiguous()
    dx = _launch("hvc_conv3d_k3s1_fwd", 1, g, wt, None)
    conv3d_k3s1_dgrad.launches += 1
    return dx


def conv3d_k3s2_dgrad(g: torch.Tensor, w: torch.Tensor, x_shape) -> torch.Tensor:
    """Kernel F: dx (x_shape, g's dtype) of the stride-2 conv for output
    gradient g; w (Cout, Cin, 3, 3, 3) in g's dtype."""
    if g.device.type == "cpu":
        return conv3d_k3_dgrad_plain(g, w, x_shape, 2)
    if g.device.type != "cuda":
        raise RuntimeError(f"conv3d_k3 runs on cuda or cpu tensors, got {g.device}")
    cout, cin = w.shape[:2]
    if tuple(w.shape[2:]) != (3, 3, 3) or x_shape[1] != cin:
        raise ValueError(f"w {tuple(w.shape)} does not fit x {tuple(x_shape)}")
    _check_grad(x_shape, g, 2, cout, ("w", w))
    B, _, D, H, W = x_shape
    dx = torch.empty(tuple(x_shape), dtype=g.dtype, device=g.device)
    fn = _build.function("hvc_conv3d_k3s2_dgrad", _DGRAD_ARGTYPES)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = fn(g.data_ptr(), w.data_ptr(), dx.data_ptr(), B, cin, cout, D, H, W,
                _DTYPE_CODES[g.dtype], stream)
    _build.check(rc, "hvc_conv3d_k3s2_dgrad")
    conv3d_k3s2_dgrad.launches += 1
    return dx


conv3d_k3s1_wgrad.launches = 0
conv3d_k3s1_dgrad.launches = 0
conv3d_k3s2_wgrad.launches = 0
conv3d_k3s2_dgrad.launches = 0
