"""Kernels B and C: 3×3×3 conv forward, stride 1 and 2 (``csrc/conv3d_k3.cu``).

Counterparts of ``hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3.py``
(``_conv_fwd``) and ``hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3s2.py``
(``_conv_fwd_s2``). Semantics: ``F.conv3d(x, w, b, stride, padding=1)`` on
NCDHW input, OIDHW weights, fp32 bias and accumulation, output in x's dtype.
The weight- and data-gradient kernels are not ported yet.

``conv3d_k3s1`` and ``conv3d_k3s2`` launch the CUDA kernel for tensors on a
CUDA device and run ``conv3d_k3_plain`` for tensors on the CPU; for any other
device they raise. They never fall back from the kernel to the plain
version. ``conv3d_k3s1.launches`` and ``conv3d_k3s2.launches`` count kernel
launches.
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
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv3d(x.float(), w.float(), b, stride=stride, padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return y.to(x.dtype)


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
