"""Kernel family N: the implicit-GEMM conv probes on the tensor cores
(``csrc/conv_probe.cu``).

Counterparts of the Pallas probe kernels of the stage-3 64→32 3×3×3 conv,
one wrapper per TPU function, named after it, in its argument order and
layouts: ``probe_v1`` (``scripts/bench_pallas_conv_probe.py::make_v1``, any
m: V1 is m = 32, the V0 control m = 256), ``probe_v2`` (``::v2``),
``probe_v3`` (``::v3``), and ``probe_v3p``, ``probe_v5``, ``probe_v6``,
``probe_v4``, ``probe_v8`` (``scripts/bench_pallas_conv_probe2.py::v3p``,
``v5``, ``v6``, ``v4``, ``v8``). Every operand is bf16, 2-D and contiguous;
every output is fp32. A call does ``repeats`` passes over the same data, as
the TPU probe's r grid axis does (the r axis is a loop inside one launch, so
a call counts one launch), and returns the last pass's output.

Each wrapper launches its CUDA kernel for tensors on a CUDA device and runs
its plain version (``*_plain``: fp32 products of the bf16 inputs, the tap
sums written out, ``repeats`` passes) for tensors on the CPU; for any other
device it raises. It never falls back from the kernel to the plain version.
Each launch adds one to the wrapper's counter in ``LAUNCHES``; a launch on a
wgmma instance also adds one to that instance's counter: ``probe_v1`` on
V0's (``probe_v1_instance`` = ``V1_WGMMA_V0``) to ``conv_probe_v1_wgmma``, on
V1's (``V1_WGMMA_M32``) to ``conv_probe_v1_wgmma_m32``, every ``probe_v2``
launch (``probe_v2_instance`` = ``V2_WGMMA``) to ``conv_probe_v2_wgmma``,
and ``probe_v3``, ``probe_v3p``, ``probe_v4``, ``probe_v6``, ``probe_v5`` and
``probe_v8`` on their wgmma instances (``probe_v3_instance`` = ``V3_WGMMA``,
``probe_v3p_instance`` = ``V3P_WGMMA``, and so on) to
``conv_probe_v3_wgmma``, ``conv_probe_v3p_wgmma``, ``conv_probe_v4_wgmma``,
``conv_probe_v6_wgmma``, ``conv_probe_v5_wgmma`` and ``conv_probe_v8_wgmma``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

K = 1728   # 64 input channels × 27 taps: the im2col depth
CIN = 64
COUT = 32
TAPS = 27

_P, _I = ctypes.c_void_p, ctypes.c_int
# hvc_probe_v1(w, p, out, m, k, n, repeats, aligned, stream)
_V1_ARGTYPES = (_P, _P, _P, _I, _I, _I, _I, _I, _P)
# hvc_probe_v1_rule(m, k, n): the instance code hvc_probe_v1 takes
_V1_RULE_ARGTYPES = (_I, _I, _I)
# hvc_probe_v2(pt, wt, out, k, n, repeats, stream)
_V2_ARGTYPES = (_P, _P, _P, _I, _I, _I, _P)
# hvc_probe_v2_rule(k, n): the instance code hvc_probe_v2 takes (-1: none)
_V2_RULE_ARGTYPES = (_I, _I)
# hvc_probe_{v3,v3p,v4,v6,v5,v8}_rule(n): the instance code hvc_probe_{v3,...} takes
_TAP_RULE_ARGTYPES = (_I,)
# hvc_probe_{v3,v3p,v5,v6,v4,v8}(w, x, out, n, repeats, aligned, stream)
_TAP_ARGTYPES = (_P, _P, _P, _I, _I, _I, _P)

# Kernel launches per wrapper since the last reset (ops.cuda.launch_counts).
LAUNCHES = {**{f"conv_probe_{v}": 0 for v in ("v1", "v2", "v3", "v3p", "v5", "v6", "v4", "v8")},
            "conv_probe_v1_wgmma": 0, "conv_probe_v1_wgmma_m32": 0, "conv_probe_v2_wgmma": 0,
            "conv_probe_v3_wgmma": 0, "conv_probe_v3p_wgmma": 0, "conv_probe_v4_wgmma": 0,
            "conv_probe_v6_wgmma": 0, "conv_probe_v5_wgmma": 0, "conv_probe_v8_wgmma": 0}
# The instance codes of hvc_probe_v1, hvc_probe_v2, hvc_probe_v3,
# hvc_probe_v3p, hvc_probe_v4, hvc_probe_v6, hvc_probe_v5 and hvc_probe_v8
# (V1Instance … V8Instance in csrc/conv_probe.cu): V1 on the 32 × 128 or the
# 128 × 128 mma.sync tiles, V0's wgmma instance (WgV0), V1's (WgV1); V2 on
# its wgmma instance with wt resident (WgV2); V3 on the 32 × 128 mma.sync
# tiles or on its wgmma instance (WgV3); V3' on probe_tapsum (mma.sync) or
# on its per-tap wgmma instance (WgV3p: X as A in registers, w27 resident as
# B); V4, V6, V5 and V8 on probe_tapsum (mma.sync) or on their wgmma
# instances with the weights resident as A (WgV4, which V6 shares, WgV5,
# WgV8).
V1_MMA_NARROW, V1_MMA_WIDE, V1_WGMMA_V0, V1_WGMMA_M32 = 0, 1, 2, 3
V2_WGMMA = 1
V3_MMA, V3_WGMMA = 0, 1
V3P_MMA, V3P_WGMMA = 0, 1
V4_MMA, V4_WGMMA = 0, 1
V6_MMA, V6_WGMMA = 0, 1
V5_MMA, V5_WGMMA = 0, 1
V8_MMA, V8_WGMMA = 0, 1
_INSTANCE_COUNTERS = {("v1", V1_WGMMA_V0): "conv_probe_v1_wgmma",
                      ("v1", V1_WGMMA_M32): "conv_probe_v1_wgmma_m32",
                      ("v2", V2_WGMMA): "conv_probe_v2_wgmma",
                      ("v3", V3_WGMMA): "conv_probe_v3_wgmma",
                      ("v3p", V3P_WGMMA): "conv_probe_v3p_wgmma",
                      ("v4", V4_WGMMA): "conv_probe_v4_wgmma",
                      ("v6", V6_WGMMA): "conv_probe_v6_wgmma",
                      ("v5", V5_WGMMA): "conv_probe_v5_wgmma",
                      ("v8", V8_WGMMA): "conv_probe_v8_wgmma"}
# The wgmma instances' rows per m64 tile, the row pitch their tensor maps
# need (16 bytes: 8 bf16 of P), the most rows V1's instance takes (one
# half-filled m64 tile) and the deepest wt V2's keeps in shared memory.
WGMMA_M, WGMMA_N_ALIGN, WGMMA_M32, V2_MAX_K = 64, 8, 32, 1792


# --------------------------------------------------------- plain versions ---

def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b of fp32 operands in full fp32 (cuBLAS TF32 off for the call)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _tap_sum(w: torch.Tensor, x: torch.Tensor, taps: int, x_rows_per_tap: int = 0) -> torch.Tensor:
    """Σ_{t<taps} w[32t:32t+32] · x_t in fp32, x_t = x[t·r:(t+1)·r] with
    r = x_rows_per_tap, or all of x when it is 0 (one x shared by every tap)."""
    wf, xf = w.float(), x.float()
    kd = w.shape[1]
    acc = None
    for t in range(taps):
        xt = xf[t * x_rows_per_tap:t * x_rows_per_tap + kd] if x_rows_per_tap else xf
        part = _mm(wf[COUT * t:COUT * (t + 1)], xt)
        acc = part if acc is None else acc + part
    return acc


def _check_repeats(repeats: int) -> None:
    if repeats < 1:
        raise ValueError(f"repeats must be ≥ 1, got {repeats}")


def _passes(repeats: int, fn):
    """fn() `repeats` times; the last result."""
    _check_repeats(repeats)
    for _ in range(repeats):
        out = fn()
    return out


def probe_v1_plain(w: torch.Tensor, p: torch.Tensor, repeats: int) -> torch.Tensor:
    """out (m, N) = w (m, K) · p (K, N)."""
    wf, pf = w.float(), p.float()
    return _passes(repeats, lambda: _mm(wf, pf))


def probe_v2_plain(p: torch.Tensor, w: torch.Tensor, repeats: int) -> torch.Tensor:
    """out (N, 32) = p (N, K) · w (K, 32): spatial rows as M."""
    pf, wf = p.float(), w.float()
    return _passes(repeats, lambda: _mm(pf, wf))


def probe_v3_plain(w27: torch.Tensor, p: torch.Tensor, repeats: int) -> torch.Tensor:
    """out (32, N) = Σ_{t<27} w27[32t:32t+32] (32, 64) · p[64t:64t+64] (64, N)."""
    return _passes(repeats, lambda: _tap_sum(w27, p, TAPS, CIN))


def probe_v3p_plain(w27: torch.Tensor, x: torch.Tensor, repeats: int) -> torch.Tensor:
    """out (32, N) = Σ_{t<27} w27[32t:32t+32] (32, 64) · x (64, N)."""
    return _passes(repeats, lambda: _tap_sum(w27, x, TAPS))


def probe_v5_plain(w14: torch.Tensor, x2: torch.Tensor, repeats: int) -> torch.Tensor:
    """out (32, N) = Σ_{t<14} w14[32t:32t+32] (32, 128) · x2 (128, N)."""
    return _passes(repeats, lambda: _tap_sum(w14, x2, 14))


def probe_v6_plain(w27p: torch.Tensor, x: torch.Tensor, repeats: int) -> torch.Tensor:
    """7 dots w27p[128g:128g+128] · x; each dot's 32-row groups summed into
    out (32, N), the last dot's first 3 only (taps 0-26 of the 28 row groups)."""
    wf, xf = w27p.float(), x.float()

    def one_pass():
        acc = None
        for g in range(7):
            out4 = _mm(wf[4 * COUT * g:4 * COUT * (g + 1)], xf)
            for t in range(4 if g < 6 else 3):
                part = out4[COUT * t:COUT * (t + 1)]
                acc = part.clone() if acc is None else acc + part
        return acc

    return _passes(repeats, one_pass)


def probe_v4_plain(w27: torch.Tensor, x: torch.Tensor, repeats: int) -> torch.Tensor:
    """One dot w27 (864, 64) · x, then its 27 row groups of 32 summed."""
    wf, xf = w27.float(), x.float()

    def one_pass():
        out = _mm(wf, xf)
        acc = out[:COUT].clone()
        for t in range(1, TAPS):
            acc += out[COUT * t:COUT * (t + 1)]
        return acc

    return _passes(repeats, one_pass)


def probe_v8_plain(w9: torch.Tensor, x3: torch.Tensor, repeats: int) -> torch.Tensor:
    """out (32, N) = Σ_{t<9} w9[32t:32t+32] (32, 192) · x3 (192, N)."""
    return _passes(repeats, lambda: _tap_sum(w9, x3, 9))


# ---------------------------------------------------------------- checks ---

def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    """t is bf16, 2-D with `shape` (None = any extent ≥ 1), contiguous, on `device`."""
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
    if t.dim() != 2 or any(s is not None and s != n for s, n in zip(shape, t.shape)) \
            or min(t.shape) < 1:
        want = "(" + ", ".join("n" if s is None else str(s) for s in shape) + ")"
        raise ValueError(f"{name} must have shape {want}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if max(t.shape) > 2**31 - 1:
        raise ValueError(f"{name} {tuple(t.shape)}: dimension too large for the kernel")


def _on_card(*ts: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU ones (plain
    version); any other device raises."""
    dev = ts[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"conv_probe runs on cuda or cpu tensors, got {dev}")
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError("conv_probe needs 16-byte aligned operands")
    return True


def _launch(variant: str, argtypes, a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
            *ints: int, instance: int = -1) -> torch.Tensor:
    entry = f"hvc_probe_{variant}"
    fn = _build.function(entry, argtypes)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), *ints, stream)
    _build.check(rc, entry)
    LAUNCHES[f"conv_probe_{variant}"] += 1
    if (variant, instance) in _INSTANCE_COUNTERS:
        LAUNCHES[_INSTANCE_COUNTERS[variant, instance]] += 1
    return out


# ---------------------------------------------------------------- wrappers ---

def probe_v1_instance(m: int, k: int, n: int) -> int:
    """The instance ``probe_v1`` takes, the rule of ``v1_instance``
    (csrc/conv_probe.cu), which the wrapper reads through
    ``hvc_probe_v1_rule``: with N a multiple of 8 (16-byte rows of P and the
    output for the tensor maps), m a multiple of 64 (whole m64 tiles: V0)
    runs on ``V1_WGMMA_V0`` (``probe_gemm_wgmma<WgV0>``: 256 rows × 128
    columns a work item) and m ≤ 32 (V1) on ``V1_WGMMA_M32``
    (``probe_gemm_wgmma<WgV1>``: W's rows the top of one m64 tile, 256
    columns a work item); otherwise m ≤ 32 on the 32 × 128 mma.sync instance
    (``V1_MMA_NARROW``), the rest on the 128 × 128 one (``V1_MMA_WIDE``)."""
    if n % WGMMA_N_ALIGN == 0 and m % WGMMA_M == 0:
        return V1_WGMMA_V0
    if n % WGMMA_N_ALIGN == 0 and m <= WGMMA_M32:
        return V1_WGMMA_M32
    return V1_MMA_NARROW if m <= WGMMA_M32 else V1_MMA_WIDE


def probe_v2_instance(k: int, n: int) -> int:
    """The instance ``probe_v2`` takes, the rule of ``v2_instance``
    (csrc/conv_probe.cu), read through ``hvc_probe_v2_rule``: every K (a
    multiple of 64) up to ``V2_MAX_K``, at any N, runs on ``V2_WGMMA``
    (``probe_gemm_wgmma<WgV2>``: wt resident in shared memory, 256 spatial
    rows × 32 a work item); a deeper K has no instance (-1)."""
    return V2_WGMMA if k >= 64 and k % 64 == 0 and k <= V2_MAX_K else -1


def probe_v1(w: torch.Tensor, p: torch.Tensor, repeats: int) -> torch.Tensor:
    """``make_v1(m)``: out (m, N) fp32 = w (m, K) · p (K, N), weights as M;
    K a multiple of 64 (the probe's 1728); on the instance
    ``probe_v1_instance`` names."""
    _check_repeats(repeats)
    _check("w", w, (None, None), p.device)
    _check("p", p, (w.shape[1], None), p.device)
    if w.shape[1] % 64:
        raise ValueError(f"K must be a multiple of 64, got {w.shape[1]}")
    if not _on_card(w, p):
        return probe_v1_plain(w, p, repeats)
    (m, k), n = w.shape, p.shape[1]
    instance = _build.function("hvc_probe_v1_rule", _V1_RULE_ARGTYPES)(m, k, n)
    out = torch.empty((m, n), dtype=torch.float32, device=p.device)
    return _launch("v1", _V1_ARGTYPES, w, p, out, m, k, n, repeats, int(n % 8 == 0),
                   instance=instance)


def probe_v2(p: torch.Tensor, w: torch.Tensor, repeats: int) -> torch.Tensor:
    """``v2``: out (N, 32) fp32 = p (N, K) · w (K, 32), spatial rows as M;
    K a multiple of 64, at most ``V2_MAX_K`` (w stays in shared memory); on
    the instance ``probe_v2_instance`` names."""
    _check_repeats(repeats)
    _check("p", p, (None, None), p.device)
    _check("w", w, (p.shape[1], COUT), p.device)
    if p.shape[1] % 64 or p.shape[1] > V2_MAX_K:
        raise ValueError(f"K must be a multiple of 64 up to {V2_MAX_K}, got {p.shape[1]}")
    if not _on_card(p, w):
        return probe_v2_plain(p, w, repeats)
    n, k = p.shape
    instance = _build.function("hvc_probe_v2_rule", _V2_RULE_ARGTYPES)(k, n)
    out = torch.empty((n, COUT), dtype=torch.float32, device=p.device)
    return _launch("v2", _V2_ARGTYPES, p, w, out, k, n, repeats, instance=instance)


def probe_v3_instance(n: int) -> int:
    """The instance ``probe_v3`` takes, the rule of ``v3_instance``
    (csrc/conv_probe.cu), read through ``hvc_probe_v3_rule``: with N a
    multiple of 8 (16-byte rows of P and the output for the tensor maps)
    ``V3_WGMMA`` (``probe_gemm_wgmma<WgV3>``: V1's wgmma instance with K chunk
    t's A box the 64 rows of w27 from row 32t), otherwise the 32 × 128
    mma.sync instance (``V3_MMA``)."""
    return V3_WGMMA if n % WGMMA_N_ALIGN == 0 else V3_MMA


def probe_v3p_instance(n: int) -> int:
    """The instance ``probe_v3p`` takes, the rule of ``v3p_instance``
    (csrc/conv_probe.cu), read through ``hvc_probe_v3p_rule``: with N a
    multiple of 8 (16-byte rows of x for its tensor map) ``V3P_WGMMA``
    (``probe_pertap_wgmma``, ``WgV3p``: 27 per-tap dots chained into one
    accumulator, 64 columns of x as wgmma's M in registers, Cout = 32 as its
    N, w27 resident as B, 256 columns a work item), otherwise
    ``probe_tapsum`` on mma.sync (``V3P_MMA``)."""
    return V3P_WGMMA if n % WGMMA_N_ALIGN == 0 else V3P_MMA


def probe_v4_instance(n: int) -> int:
    """The instance ``probe_v4`` takes, the rule of ``v4_instance``
    (csrc/conv_probe.cu), read through ``hvc_probe_v4_rule``: with N a
    multiple of 8 (16-byte rows of x and the output for the tensor maps)
    ``V4_WGMMA`` (``probe_tapsum_wgmma<WgV4>``: w27 resident as wgmma's A,
    two taps to an m64 tile, one accumulator chain, 128 columns a work
    item), otherwise ``probe_tapsum`` on mma.sync (``V4_MMA``)."""
    return V4_WGMMA if n % WGMMA_N_ALIGN == 0 else V4_MMA


def probe_v6_instance(n: int) -> int:
    """The instance ``probe_v6`` takes, the rule of ``v6_instance``
    (csrc/conv_probe.cu), read through ``hvc_probe_v6_rule``: with N a
    multiple of 8 ``V6_WGMMA`` (``probe_tapsum_wgmma<WgV4>``, V4's instance:
    the first 864 rows of w27p resident as wgmma's A, the same sum),
    otherwise ``probe_tapsum`` on mma.sync (``V6_MMA``)."""
    return V6_WGMMA if n % WGMMA_N_ALIGN == 0 else V6_MMA


def probe_v5_instance(n: int) -> int:
    """The instance ``probe_v5`` takes, the rule of ``v5_instance``
    (csrc/conv_probe.cu), read through ``hvc_probe_v5_rule``: with N a
    multiple of 8 ``V5_WGMMA`` (``probe_tapsum_wgmma<WgV5>``: w14 resident as
    wgmma's A, two taps to an m64 tile, each tap's K = 128 in two k64 chunks,
    128 columns a work item), otherwise ``probe_tapsum`` on mma.sync
    (``V5_MMA``)."""
    return V5_WGMMA if n % WGMMA_N_ALIGN == 0 else V5_MMA


def probe_v8_instance(n: int) -> int:
    """The instance ``probe_v8`` takes, the rule of ``v8_instance``
    (csrc/conv_probe.cu), read through ``hvc_probe_v8_rule``: with N a
    multiple of 8 ``V8_WGMMA`` (``probe_tapsum_wgmma<WgV8>``: w9 resident as
    wgmma's A, each tap's K = 192 in three k64 chunks, the folded output
    stored from registers), otherwise ``probe_tapsum`` on mma.sync
    (``V8_MMA``)."""
    return V8_WGMMA if n % WGMMA_N_ALIGN == 0 else V8_MMA


def _tap_probe(variant: str, plain, w: torch.Tensor, x: torch.Tensor, w_shape: tuple,
               x_rows: int, repeats: int, rule=None) -> torch.Tensor:
    """A wrapper of the tap-sum probes (out (32, N)); ``rule``: the C entry
    point naming the instance a call of N columns takes, if it has several."""
    _check_repeats(repeats)
    _check("w", w, w_shape, x.device)
    _check("x", x, (x_rows, None), x.device)
    if not _on_card(w, x):
        return plain(w, x, repeats)
    n = x.shape[1]
    instance = -1 if rule is None else _build.function(rule, _TAP_RULE_ARGTYPES)(n)
    out = torch.empty((COUT, n), dtype=torch.float32, device=x.device)
    return _launch(variant, _TAP_ARGTYPES, w, x, out, n, repeats, int(n % 8 == 0),
                   instance=instance)


def probe_v3(w27: torch.Tensor, p: torch.Tensor, repeats: int) -> torch.Tensor:
    """``v3``: out (32, N) = Σ_{t<27} w27[32t:32t+32] · p[64t:64t+64];
    w27 (864, 64), p (1728, N): 27 shifted K = 64 dots; on the instance
    ``probe_v3_instance`` names."""
    return _tap_probe("v3", probe_v3_plain, w27, p, (TAPS * COUT, CIN), K, repeats,
                      rule="hvc_probe_v3_rule")


def probe_v3p(w27: torch.Tensor, x: torch.Tensor, repeats: int) -> torch.Tensor:
    """``v3p`` (V3'): out (32, N) = Σ_{t<27} w27[32t:32t+32] · x; w27
    (864, 64), x (64, N) shared by every tap; on the instance
    ``probe_v3p_instance`` names."""
    return _tap_probe("v3p", probe_v3p_plain, w27, x, (TAPS * COUT, CIN), CIN, repeats,
                      rule="hvc_probe_v3p_rule")


def probe_v5(w14: torch.Tensor, x2: torch.Tensor, repeats: int) -> torch.Tensor:
    """``v5``: out (32, N) = Σ_{t<14} w14[32t:32t+32] · x2; w14 (448, 128),
    x2 (128, N): pair-packed K = 128; on the instance ``probe_v5_instance``
    names."""
    return _tap_probe("v5", probe_v5_plain, w14, x2, (14 * COUT, 2 * CIN), 2 * CIN, repeats,
                      rule="hvc_probe_v5_rule")


def probe_v6(w27p: torch.Tensor, x: torch.Tensor, repeats: int) -> torch.Tensor:
    """``v6``: 7 dots of M = 128 rows of w27p (896, 64) with x (64, N), their
    32-row groups summed into out (32, N) (27 of the 28 groups); on the
    instance ``probe_v6_instance`` names."""
    return _tap_probe("v6", probe_v6_plain, w27p, x, (28 * COUT, CIN), CIN, repeats,
                      rule="hvc_probe_v6_rule")


def probe_v4(w27: torch.Tensor, x: torch.Tensor, repeats: int) -> torch.Tensor:
    """``v4``: one M = 864 dot w27 (864, 64) · x (64, N), its 27 row groups
    summed into out (32, N); on the instance ``probe_v4_instance`` names."""
    return _tap_probe("v4", probe_v4_plain, w27, x, (TAPS * COUT, CIN), CIN, repeats,
                      rule="hvc_probe_v4_rule")


def probe_v8(w9: torch.Tensor, x3: torch.Tensor, repeats: int) -> torch.Tensor:
    """``v8``: out (32, N) = Σ_{t<9} w9[32t:32t+32] · x3; w9 (288, 192), x3
    (192, N): K = 192; on the instance ``probe_v8_instance`` names."""
    return _tap_probe("v8", probe_v8_plain, w9, x3, (9 * COUT, 3 * CIN), 3 * CIN, repeats,
                      rule="hvc_probe_v8_rule")
