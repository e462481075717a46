"""Kernel A: flash attention forward (``csrc/flash_attention.cu``).

Counterpart of ``hybrid_vit_cascade_tpu/ops/pallas/flash_attention.py``
(``_flash_fwd_padded``, kernel body ``_fwd_kernel``). The backward kernels
are not ported yet.

``flash_attention_fwd`` launches the CUDA kernel for a tensor on a CUDA
device and runs ``flash_attention_plain`` for a tensor on the CPU; for any
other device it raises. It never falls back from the kernel to the plain
version. ``flash_attention_fwd.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

HEAD_DIMS = (32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
)
# Score elements per chunk of the plain version: 2**28 fp32 scores = 1 GiB.
# Unchunked, the stage-3 self-attention (8 heads × 32,768²) would need 34 GB.
_PLAIN_CHUNK_SCORES = 1 << 28


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Explicit softmax(q·kᵀ·scale)·v in fp32, chunked over query rows.

    q (BH, Nq, d), k and v (BH, Nk, d) → (out (BH, Nq, d) in q's dtype,
    lse (BH, Nq) fp32, natural log)."""
    bh, nq, _ = q.shape
    nk = k.shape[1]
    kt = k.float().transpose(1, 2)
    vf = v.float()
    rows = max(1, _PLAIN_CHUNK_SCORES // (bh * nk))
    out = torch.empty_like(q)
    lse = torch.empty((bh, nq), dtype=torch.float32, device=q.device)
    for r0 in range(0, nq, rows):
        s = torch.matmul(q[:, r0:r0 + rows].float(), kt) * scale
        l = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - l[..., None])
        out[:, r0:r0 + rows] = torch.matmul(p, vf).to(q.dtype)
        lse[:, r0:r0 + rows] = l
    return out, lse


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q in dtype and device: "
                             f"{t.dtype}/{t.device} vs {q.dtype}/{q.device}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"expected q (BH, Nq, d), k = v (BH, Nk, d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, nq, d = q.shape
    if k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the kernel (takes {HEAD_DIMS})")
    if not (1 <= bh <= 65535) or nq < 1 or k.shape[1] < 1:
        raise ValueError(f"unsupported sizes BH={bh} Nq={nq} Nk={k.shape[1]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Softmax attention without materialised scores.

    q (BH, Nq, d), k and v (BH, Nk, d), contiguous, fp32 or bf16, d ∈ {32, 64}
    → (out (BH, Nq, d) in q's dtype, lse (BH, Nq) fp32, natural log)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash attention runs on cuda or cpu tensors, got {q.device}")
    _check(q, k, v)
    bh, nq, d = q.shape
    nk = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((bh, nq), dtype=torch.float32, device=q.device)
    fn = _build.function("hvc_flash_attention_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                bh, nq, nk, d, _DTYPE_CODES[q.dtype], float(scale), stream)
    _build.check(rc, "hvc_flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
