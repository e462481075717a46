"""Kernels A, D, L and M: flash attention forward (``csrc/flash_attention.cu``),
fused backward (``csrc/flash_attention_bwd.cu``) and split backward
(``csrc/flash_attention_bwd_split.cu``).

Counterparts of ``hybrid_vit_cascade_tpu/ops/pallas/flash_attention.py``:
``_flash_fwd_padded`` (kernel body ``_fwd_kernel``), the fused backward
``_bwd_pallas_fused`` (kernel body ``_bwd_fused_kernel``) and the split
backward ``_bwd_pallas`` (kernel bodies ``_bwd_dq_kernel``, L here, and
``_bwd_dkv_kernel``, M here), which the JAX package runs when
``HVC_FLASH_FUSED_BWD=0`` (``ops/attention.py`` picks between D and L+M).

``flash_attention_fwd``, ``flash_attention_bwd``, ``flash_attention_bwd_split``
and its halves ``flash_attention_bwd_dq`` / ``flash_attention_bwd_dkv`` launch
the CUDA kernels for tensors on a CUDA device and run ``flash_attention_plain``
/ ``flash_attention_bwd_plain`` for tensors on the CPU; for any other device
they raise. They never fall back from the kernel to the plain version. Each
kernel counts its launches in the ``.launches`` of its wrapper (L in
``flash_attention_bwd_dq``'s, M in ``flash_attention_bwd_dkv``'s). Each of
A, D, L and M has two instances, by an explicit rule
(``fwd_uses_tensor_cores``, ``bwd_uses_tensor_cores``,
``bwd_dq_uses_tensor_cores``, ``bwd_dkv_uses_tensor_cores``): bf16 on the
tensor cores, whose launches also count in ``.tc_launches`` of the same
wrapper, and fp32 on the CUDA cores. M's tensor-core instance is D's body
without its dq phase; L's takes queries as M, as A does.

Head dims: each kernel has instances at d = 32, 64 and 128 (``HEAD_DIMS``).
Any other d ≤ 128 is zero-padded along d to the next of them by the
wrappers (``_at_kernel_head_dim``: ``kernel_head_dim`` names the
instance, ``pad_head_dim`` pads):
zero lanes add nothing to q·kᵀ and give zero output lanes, the caller's
scale (the real d's) is kept, and out, dq, dk and dv are sliced back to d.
The TPU kernel pads d to 128 lanes the same way. d > 128 has no instance
and is refused.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
)
_BWD_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
)
# hvc_flash_attention_bwd(q, k, v, dout, lse, delta, dq_scratch, counters, dq, dk, dv,
#                         BH, Nq, Nk, d, dtype, groups, scale, stream)
_FUSED_ARGTYPES = ((ctypes.c_void_p,) * 11 + (ctypes.c_longlong,) * 3 + (ctypes.c_int,) * 3
                   + (ctypes.c_float, ctypes.c_void_p))
# Kernel D on the CUDA cores: keys per key tile, and the blocks per SM its
# group count aims for (csrc/flash_attention_bwd.cu: 64 or 128 threads, ~41 KB
# of shared memory).
_BKV = 64
_D_BLOCKS_PER_SM = 4
# Kernel D on the tensor cores: keys per work item (16 a warp, 8 warps) and
# query rows per tile, each (head, query tile) with one int32 counter.
_TC_KEYS = 128
_TC_ROWS = 64
# Score elements per chunk of the plain versions: 2**28 fp32 scores = 1 GiB.
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


def kernel_head_dim(d: int) -> int:
    """The instance a head dim ``d`` runs on: the least of ``HEAD_DIMS`` ≥ d
    (a smaller d is zero-padded to it). Raises for d > 128, which no
    instance takes."""
    if not 1 <= d <= HEAD_DIMS[-1]:
        raise ValueError(f"head dim {d}: the flash attention kernels take head dims up to "
                         f"{HEAD_DIMS[-1]} (instances {HEAD_DIMS}, a smaller d zero-padded to "
                         f"the next)")
    return next(h for h in HEAD_DIMS if h >= d)


def pad_head_dim(t: torch.Tensor, d_kernel: int) -> torch.Tensor:
    """``t`` (..., d) zero-padded along its last axis to ``d_kernel``: a new
    contiguous tensor (so 16-byte aligned, as the bf16 kernels need), or
    ``t`` itself when d is ``d_kernel``."""
    d = t.shape[-1]
    return t if d == d_kernel else torch.nn.functional.pad(t, (0, d_kernel - d))


def _at_kernel_head_dim(fn, q, *args):
    """``fn(q, *args)`` at the instance's head dim: the (BH, N, d) arguments
    zero-padded along d to ``kernel_head_dim(d)``, the (BH, N, ·) results
    sliced back to d, contiguous; ``fn`` as it is at an instance's own d. An
    argument of another d goes to ``fn`` as it is, which refuses it."""
    d = q.shape[-1]
    dk = kernel_head_dim(d)
    if dk == d:
        return fn(q, *args)
    got = fn(*(pad_head_dim(t, dk) if isinstance(t, torch.Tensor) and t.dim() == 3
               and t.shape[-1] == d else t for t in (q, *args)))
    one = isinstance(got, torch.Tensor)
    sliced = tuple(g[..., :d].contiguous() if g.dim() == 3 else g for g in ((got,) if one else got))
    return sliced[0] if one else sliced


def _pads_head_dim(fn):
    """The kernel wrapper ``fn`` with its CUDA calls taken through
    ``_at_kernel_head_dim``."""
    @functools.wraps(fn)
    def run(q, *args):
        if q.device.type != "cuda" or q.dim() != 3:
            return fn(q, *args)
        return _at_kernel_head_dim(fn, q, *args)
    return run


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
    kernel_head_dim(d)
    if not (1 <= bh <= 65535) or nq < 1 or k.shape[1] < 1:
        raise ValueError(f"unsupported sizes BH={bh} Nq={nq} Nk={k.shape[1]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fwd_uses_tensor_cores(dtype: torch.dtype) -> bool:
    """Which instance of kernel A a call takes, the rule of
    ``hvc_flash_attention_fwd``: bf16 on the tensor cores (the probabilities
    rounded to bf16 into P·V, as the TPU kernel does); fp32 on the CUDA cores
    (TF32 would leave the fp32 tolerances)."""
    return dtype == torch.bfloat16


@_pads_head_dim
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Softmax attention without materialised scores.

    q (BH, Nq, d), k and v (BH, Nk, d), contiguous, fp32 or bf16 (16-byte
    aligned), d ≤ 128 (zero-padded to the instance ``kernel_head_dim``
    names) → (out (BH, Nq, d) in q's dtype, lse (BH, Nq) fp32, natural
    log)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash attention runs on cuda or cpu tensors, got {q.device}")
    _check(q, k, v)
    tc = fwd_uses_tensor_cores(q.dtype)
    if tc and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the bf16 flash forward needs q, k and v 16-byte aligned")
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
    flash_attention_fwd.tc_launches += tc
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.tc_launches = 0


def _delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = Σ_d dout·out per query row, fp32 (BH, Nq): the softmax
    backward's row term, computed before the kernel as _bwd_pallas_fused does."""
    return (dout.float() * out.float()).sum(-1)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                              scale: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Recompute-softmax backward in fp32, chunked over query rows:
    p = exp(q·kᵀ·scale − lse), dv = pᵀ·do, ds = p·(do·vᵀ − delta),
    dq = ds·k·scale, dk = dsᵀ·q·scale. Returns (dq, dk, dv) in q's dtype."""
    bh, nq, _ = q.shape
    nk = k.shape[1]
    kf, vf = k.float(), v.float()
    delta = _delta(out, dout)
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    rows = max(1, _PLAIN_CHUNK_SCORES // (bh * nk))
    for r0 in range(0, nq, rows):
        qc, dc = q[:, r0:r0 + rows].float(), dout[:, r0:r0 + rows].float()
        p = torch.exp(torch.matmul(qc, kf.transpose(1, 2)) * scale - lse[:, r0:r0 + rows, None])
        dv += torch.matmul(p.transpose(1, 2), dc)
        ds = p * (torch.matmul(dc, vf.transpose(1, 2)) - delta[:, r0:r0 + rows, None])
        dq[:, r0:r0 + rows] = (torch.matmul(ds, kf) * scale).to(q.dtype)
        dk += torch.matmul(ds.transpose(1, 2), qc) * scale
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
               lse: torch.Tensor, dout: torch.Tensor) -> None:
    """What the backward kernels take, for tensors that are not on the CPU."""
    if q.device.type != "cuda":
        raise RuntimeError(f"flash attention runs on cuda or cpu tensors, got {q.device}")
    _check(q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q: {tuple(t.shape)} {t.dtype} {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if lse.dtype != torch.float32 or lse.shape != q.shape[:2] or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous fp32 {tuple(q.shape[:2])}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")


def dq_groups(nk: int, bh: int, sms: int) -> tuple[int, int]:
    """Kernel D's plan on the CUDA cores: (G, per), the key tiles of each head (64 keys each)
    cut into G groups of ``per`` consecutive tiles, group g taking tiles
    g·per … min(n, (g + 1)·per) − 1. G·BH blocks aim for
    ``_D_BLOCKS_PER_SM`` per SM, and no group is empty (its partial would
    stay unwritten)."""
    n_tiles = -(-nk // _BKV)
    groups = max(1, min(n_tiles, -(-_D_BLOCKS_PER_SM * sms // bh)))
    per = -(-n_tiles // groups)
    return -(-n_tiles // per), per


def bwd_uses_tensor_cores(dtype: torch.dtype) -> bool:
    """Which instance of kernel D a call takes, the rule of
    ``hvc_flash_attention_bwd`` (``bwd_uses_tc`` in C, which the wrapper
    reads through ``hvc_flash_attention_bwd_tc``): bf16 on the tensor cores
    (the probabilities and ds rounded to bf16 into their products, as the TPU
    kernel does); fp32 on the CUDA cores (TF32 would leave the fp32
    tolerances)."""
    return dtype == torch.bfloat16


def bwd_tc_scratch(bh: int, nq: int, d: int) -> tuple[int, int]:
    """(fp32 elements, int32 counters) of the tensor-core D's scratch: one
    (BH, Nq, d) dq accumulator, and the next-item counter plus one counter per
    (head, query tile of ``_TC_ROWS`` rows), all zeroed per call."""
    return bh * nq * d, 1 + bh * -(-nq // _TC_ROWS)


@_pads_head_dim
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor,
                        scale: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of ``flash_attention_fwd`` from its (out, lse) and the output
    gradient. q, dout, out (BH, Nq, d), k and v (BH, Nk, d), contiguous, one
    dtype (fp32 or bf16, 16-byte aligned), d ≤ 128 (zero-padded as the
    forward pads); lse (BH, Nq) fp32,
    natural log. Returns (dq, dk, dv) in q's dtype. Kernel D, on the instance
    the C rule names (``bwd_uses_tensor_cores``): on the tensor cores work
    items of one head's ``_TC_KEYS`` keys, handed out in index order (key tile
    i // BH of head i % BH), add their dq shares into one fp32 accumulator in
    key-tile order (``bwd_tc_scratch``); on the CUDA cores each block takes
    one group of key tiles (``dq_groups``) and adds into the group's own fp32
    partial, the partials summed in group order. Either way two runs give the
    same bits."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, scale)
    _check_bwd(q, k, v, out, lse, dout)
    bh, nq, d = q.shape
    nk = k.shape[1]
    code = _DTYPE_CODES[q.dtype]
    tc = bool(_build.function("hvc_flash_attention_bwd_tc", (ctypes.c_int,))(code))
    if tc and any(t.data_ptr() % 16 for t in (q, k, v, dout)):
        raise ValueError("the bf16 flash backward needs q, k, v and dout 16-byte aligned")
    delta = _delta(out, dout)
    if tc:
        n_acc, n_cnt = bwd_tc_scratch(bh, nq, d)
        scratch = torch.empty((n_acc,), dtype=torch.float32, device=q.device)
        counters = torch.zeros((n_cnt,), dtype=torch.int32, device=q.device)
        groups = 1
    else:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        groups, _ = dq_groups(nk, bh, sms)
        scratch = torch.empty((groups, bh, nq, d), dtype=torch.float32, device=q.device)
        counters = None
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fn = _build.function("hvc_flash_attention_bwd", _FUSED_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), scratch.data_ptr(),
                None if counters is None else counters.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), bh, nq, nk, d, code, groups, float(scale), stream)
    _build.check(rc, "hvc_flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.tc_launches += tc
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.tc_launches = 0


# kernel L: q, k, v, dout, lse, delta, dq; M: the same with dk, dv in dq's place
# (the fused layout without dq_part)
_DQ_ARGTYPES = _BWD_ARGTYPES[:7] + _BWD_ARGTYPES[9:]
_DKV_ARGTYPES = _BWD_ARGTYPES[:8] + _BWD_ARGTYPES[9:]


def _launch_split(name: str, argtypes, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, outs,
                  scale: float) -> None:
    """Launch kernel L or M (C entry point ``name``) on the current stream,
    writing into the tensors of ``outs``."""
    bh, nq, d = q.shape
    fn = _build.function(name, argtypes)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), *(t.data_ptr() for t in outs), bh, nq, k.shape[1], d,
                _DTYPE_CODES[q.dtype], float(scale), stream)
    _build.check(rc, name)


def bwd_dq_uses_tensor_cores(dtype: torch.dtype) -> bool:
    """Which instance of kernel L a call takes, the rule of
    ``hvc_flash_attention_bwd_dq`` (``dq_uses_tc`` in C, which the wrapper
    reads through ``hvc_flash_attention_bwd_dq_tc``): bf16 on the tensor cores
    (queries as M, ds rounded to bf16 into dS·K, as the TPU kernel does); fp32
    on the CUDA cores (TF32 would leave the fp32 tolerances)."""
    return dtype == torch.bfloat16


def _bwd_dq(q, k, v, dout, lse, delta, scale: float) -> torch.Tensor:
    tc = bool(_build.function("hvc_flash_attention_bwd_dq_tc", (ctypes.c_int,))(
        _DTYPE_CODES[q.dtype]))
    if tc and any(t.data_ptr() % 16 for t in (q, k, v, dout)):
        raise ValueError("the bf16 dq kernel needs q, k, v and dout 16-byte aligned")
    dq = torch.empty_like(q)
    _launch_split("hvc_flash_attention_bwd_dq", _DQ_ARGTYPES, q, k, v, dout, lse, delta, (dq,),
                  scale)
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.tc_launches += tc
    return dq


def bwd_dkv_uses_tensor_cores(dtype: torch.dtype) -> bool:
    """Which instance of kernel M a call takes, the rule of
    ``hvc_flash_attention_bwd_dkv`` (``dkv_uses_tc`` in C, which the wrapper
    reads through ``hvc_flash_attention_bwd_dkv_tc``): bf16 on the tensor
    cores (D's body without its dq phase; p and ds rounded to bf16 into their
    products, as the TPU kernel does); fp32 on the CUDA cores (TF32 would leave
    the fp32 tolerances)."""
    return dtype == torch.bfloat16


def _bwd_dkv(q, k, v, dout, lse, delta, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    tc = bool(_build.function("hvc_flash_attention_bwd_dkv_tc", (ctypes.c_int,))(
        _DTYPE_CODES[q.dtype]))
    if tc and any(t.data_ptr() % 16 for t in (q, k, v, dout)):
        raise ValueError("the bf16 dk/dv kernel needs q, k, v and dout 16-byte aligned")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_split("hvc_flash_attention_bwd_dkv", _DKV_ARGTYPES, q, k, v, dout, lse, delta,
                  (dk, dv), scale)
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.tc_launches += tc
    return dk, dv


@_pads_head_dim
def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                           lse: torch.Tensor, dout: torch.Tensor, scale: float) -> torch.Tensor:
    """Kernel L alone: dq of ``flash_attention_fwd``, in q's dtype; arguments
    as ``flash_attention_bwd``. One block per query tile (64 rows on the
    tensor cores, 128 on the CUDA cores, by ``bwd_dq_uses_tensor_cores``)
    sweeps every key, so each dq row is written once."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, scale)[0]
    _check_bwd(q, k, v, out, lse, dout)
    return _bwd_dq(q, k, v, dout, lse, _delta(out, dout), scale)


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.tc_launches = 0


@_pads_head_dim
def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor,
                            scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel M alone: (dk, dv) of ``flash_attention_fwd``, in q's dtype;
    arguments as ``flash_attention_bwd``. One block per key tile (``_TC_KEYS``
    keys on the tensor cores, 64 on the CUDA cores, by
    ``bwd_dkv_uses_tensor_cores``) sweeps every query, so each dk and dv row
    is written once."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, scale)[1:]
    _check_bwd(q, k, v, out, lse, dout)
    return _bwd_dkv(q, k, v, dout, lse, _delta(out, dout), scale)


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.tc_launches = 0


@_pads_head_dim
def flash_attention_bwd_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                              scale: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The split backward: the function of ``flash_attention_bwd`` from kernel
    L (dq) then kernel M (dk, dv), with delta computed once. No atomics: the
    result does not depend on the order in which blocks run."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, scale)
    _check_bwd(q, k, v, out, lse, dout)
    delta = _delta(out, dout)
    dq = _bwd_dq(q, k, v, dout, lse, delta, scale)
    return (dq, *_bwd_dkv(q, k, v, dout, lse, delta, scale))
