"""Tensor-core orientation probe for the stage-3 implicit-GEMM conv, on the card.

The counterpart of both JAX probe scripts, ``scripts/bench_pallas_conv_probe.py``
(V1, V0, V2, V3) and ``scripts/bench_pallas_conv_probe2.py`` (V3', V5, V6, V4,
V8, and the dense-conv yardsticks VX, VX2), with their case names and prefix
filter. The detail-enhancer conv1 (64ch -> 32ch, k3, 256^3) is the largest
conv of the stage-3 step (1.855 TFLOP forward); its Cout = 32 rows are half of
a wgmma tile's 64, so the question is which orientation, per-dot K and tap
stacking the tensor cores sustain when the kernel picks the tiles:

  V1  weights-as-LHS : out[32, N]  = W[32, 1728] @ P[1728, N]     (M = Cout)
  V0  control        : out[256, N] = A[256, 1728] @ P[1728, N]    (square-ish)
  V2  spatial-as-M   : out[N, 32]  = P[N, 1728] @ W[1728, 32]     (N = Cout)
  V3  shifted GEMMs  : out[32, N] += W_t[32, 64] @ P_t[64, N] x27 (K = Cin)
  V3' per-tap dots   : acc[32, N] += W_t[32, 64]   @ X[64, N]   x27 (X shared)
  V5  pair-packed K  : acc[32, N] += W2_t[32, 128] @ X2[128, N] x14
  V6  4-tap-stacked M: OUT4[128, N] = W4_g[128, 64] @ X[64, N] x7 + reduce
  V4  all-tap-stacked: OUT[864, N]  = W[864, 64] @ X[64, N] x1 + reduce
  V8  x-packed K     : acc[32, N] += W_t[32, 192] @ X3[192, N] x9
  VX  library dense conv 64->32 k3, 256^3, batch 1, NDHWC (cuDNN, channels_last_3d)
  VX2 library dense conv 32->64 k3, 256^3, batch 1, NDHWC

V1-V8 run the hand-written tensor-core kernels of
``hybrid_vit_cascade_tpu_torch/ops/cuda/conv_probe.py`` (kernel family N,
``csrc/conv_probe.cu``): bf16 inputs, fp32 accumulation and output, R passes
per call over the same data (``--repeats``), as the JAX probes' r grid axis.
VX and VX2 are library calls (cuDNN through ``F.conv3d``) and the yardstick.

Per case one line: the median of 5 CUDA-event times after a warm-up call, the
rate with the JAX scripts' operation count (R included), the plain version's
time (fp32 products of the bf16 inputs, R passes), the least time the
card could take (max of operations / 989 TFLOP/s and bytes / 3.35 TB/s, H100
SXM dense bf16 and HBM3, each input read once), where a pass's bytes exceed
the 50 MiB L2 also the per-pass floor (V1/V0/V2/V3: P, 453 MB; V8: X3 and
its output, 67.2 MB; re-read from device memory every pass), and one cuBLAS
call over the same operands
(``torch.mm``, R calls; fp32 out where this torch has ``out_dtype``, bf16
otherwise, as the line says) that the port never calls. The card's name and
power limit head the output; a JSON object of every row is the last line.

    python -m hybrid_vit_cascade_tpu_torch.scripts.bench_conv_probe [prefix ...]
        [--device cuda|cpu] [--repeats 64] [--n 131072] [--seed 0]

Without a card it refuses unless ``--device cpu`` is given; on the CPU the
wrappers run their plain versions, the times are the host clock's and no
device metric, and VX/VX2 run at 16³.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..ops.cuda import conv_probe as cp

PEAK_FLOPS = 989e12   # H100 SXM dense bf16
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
L2_BYTES = 50 * 2**20  # H100 SXM L2 cache
N_TOTAL = 131072
R = 64
K, CIN, COUT, TAPS = cp.K, cp.CIN, cp.COUT, cp.TAPS
_BF16 = 2


@dataclass(frozen=True)
class Case:
    key: str          # the case name of the JAX scripts
    title: str
    kernel: Optional[str]     # launch counter of the wrapper (None: a library call)
    replaces: str     # the JAX function, file:line
    w_shape: Optional[tuple]  # weight operand (None for VX)
    x_rows: int       # rows of the streamed operand (K of P, or the X depth)
    kd: int           # contraction depth of the whole product (operations per output)
    m: int            # output rows per column (Cout or the control's 256)
    wrapper: Optional[Callable] = None  # the kernel's wrapper, (weights, data, repeats)
    plain: Optional[Callable] = None    # its plain version


_P1 = "scripts/bench_pallas_conv_probe.py"
_P2 = "scripts/bench_pallas_conv_probe2.py"
CASES = [
    Case("V1", "V1 weights-as-LHS (32,1728)@(1728,n)", "conv_probe_v1", f"{_P1}:62",
         (COUT, K), K, K, COUT, cp.probe_v1, cp.probe_v1_plain),
    Case("V0", "V0 control       (256,1728)@(1728,n)", "conv_probe_v1", f"{_P1}:62",
         (256, K), K, K, 256, cp.probe_v1, cp.probe_v1_plain),
    Case("V2", "V2 spatial-as-M  (n,1728)@(1728,32)", "conv_probe_v2", f"{_P1}:88",
         (K, COUT), K, K, COUT, cp.probe_v2, cp.probe_v2_plain),
    Case("V3", "V3 27x shifted   (32,64)@(64,n)", "conv_probe_v3", f"{_P1}:116",
         (TAPS * COUT, CIN), K, K, COUT, cp.probe_v3, cp.probe_v3_plain),
    Case("V3'", "V3' 27 per-tap dots (32,64)@(64,n)", "conv_probe_v3p", f"{_P2}:67",
         (TAPS * COUT, CIN), CIN, K, COUT, cp.probe_v3p, cp.probe_v3p_plain),
    Case("V5", "V5  14 pair-packed  (32,128)@(128,n)", "conv_probe_v5", f"{_P2}:92",
         (14 * COUT, 2 * CIN), 2 * CIN, 14 * 2 * CIN, COUT, cp.probe_v5, cp.probe_v5_plain),
    Case("V6", "V6  7x 4-tap-stack  (128,64)@(64,n)+red", "conv_probe_v6", f"{_P2}:120",
         (28 * COUT, CIN), CIN, K, COUT, cp.probe_v6, cp.probe_v6_plain),
    Case("V4", "V4  all-tap-stack   (864,64)@(64,n)+red", "conv_probe_v4", f"{_P2}:146",
         (TAPS * COUT, CIN), CIN, K, COUT, cp.probe_v4, cp.probe_v4_plain),
    Case("V8", "V8  9x x-packed     (32,192)@(192,n)", "conv_probe_v8", f"{_P2}:171",
         (9 * COUT, 3 * CIN), 3 * CIN, 9 * 3 * CIN, COUT, cp.probe_v8, cp.probe_v8_plain),
    Case("VX", "VX  library dense conv 64->32 k3 256^3 NDHWC", None, f"{_P2}:224",
         None, CIN, 27 * CIN, COUT),
    Case("VX2", "VX2 library dense conv 32->64 k3 256^3 NDHWC", None, f"{_P2}:237",
         None, COUT, 27 * COUT, CIN),
]
BY_KEY = {c.key: c for c in CASES}


def select(prefixes) -> list[Case]:
    """The cases whose title starts with one of `prefixes` (all without any),
    as the JAX scripts filter."""
    return [c for c in CASES if not prefixes or any(c.title.startswith(p) for p in prefixes)]


# ------------------------------------------------------------------ inputs ---

def make_inputs(case: Case, n: int, device, seed: int, vx_size: int = 256) -> tuple:
    """The case's operands in bf16, from a torch.Generator seeded with `seed`
    on `device`: standard normal values, as the JAX scripts draw them. A
    kernel case gives its wrapper's (weights, data) in the wrapper's order;
    VX/VX2 give (x, w) as channels_last_3d tensors of a vx_size³ volume."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device, dtype=torch.bfloat16)

    if case.kernel is None:
        s = vx_size
        cin, cout = case.x_rows, case.m
        x = randn(1, cin, s, s, s).contiguous(memory_format=torch.channels_last_3d)
        w = randn(cout, cin, 3, 3, 3).contiguous(memory_format=torch.channels_last_3d)
        return x, w
    w = randn(*case.w_shape)
    if case.key == "V2":
        return randn(n, K), w
    return w, randn(case.x_rows, n)


# ------------------------------------------------------ bounds and yardstick ---

def operations(case: Case, n: int, repeats: int, vx_size: int = 256) -> float:
    """The JAX scripts' operation count: 2·R·m·kd·N (VX/VX2: one conv)."""
    if case.kernel is None:
        return 2.0 * case.m * case.kd * vx_size ** 3
    return 2.0 * repeats * case.m * case.kd * n


def nbytes(case: Case, n: int, vx_size: int = 256) -> int:
    """Bytes of one pass: each input read once, the output written once
    (fp32; VX/VX2 bf16)."""
    if case.kernel is None:
        vox = vx_size ** 3
        return _BF16 * (case.x_rows * vox + 27 * case.x_rows * case.m + case.m * vox)
    w = case.w_shape[0] * case.w_shape[1]
    return _BF16 * (w + case.x_rows * n) + 4 * case.m * n


def bound(case: Case, n: int, repeats: int, vx_size: int = 256) -> tuple[float, str]:
    """(ms, "operations" | "bytes"): the larger of the call's operations over
    PEAK_FLOPS and its bytes, each input read once, over PEAK_BYTES."""
    t_ops = operations(case, n, repeats, vx_size) / PEAK_FLOPS * 1e3
    t_bytes = nbytes(case, n, vx_size) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def pass_floor(case: Case, n: int, repeats: int) -> Optional[float]:
    """ms: R passes that each move their bytes (the streamed operand, W and
    the output) through device memory, for a kernel case whose pass does not
    fit the L2 (at N = 131,072: V1, V0, V2, V3, P 453 MB; V8, X3 and its
    output 67.2 MB); None where a pass stays in the L2 (V3', V6, V4; V5 at
    48.1 MiB) and for the library cases."""
    if case.kernel is None or nbytes(case, n) <= L2_BYTES:
        return None
    return repeats * nbytes(case, n) / PEAK_BYTES * 1e3


def _mm_out_dtype(device) -> torch.dtype:
    """fp32 where this torch's ``torch.mm`` takes ``out_dtype`` for bf16 inputs on
    `device`, else bf16."""
    a = torch.ones((16, 16), dtype=torch.bfloat16, device=device)
    try:
        torch.mm(a, a, out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return torch.bfloat16
    return torch.float32


def library_call(case: Case, args: tuple, repeats: int) -> tuple[Callable, str]:
    """(fn, description): one PyTorch call computing the case's products over
    the same operands, R times (VX/VX2: the cuDNN conv once). The tap cases
    multiply without the tap sum: V3' / V6 / V4 (864×64)·(64×N) (V6 the first
    864 of its rows), V5 (448×128)·(128×N), V8 (288×192)·(192×N); V3 its W27
    laid out as the (32×1728) W of V1."""
    if case.kernel is None:
        x, w = args
        return (lambda: F.conv3d(x, w, padding=1)), \
            "F.conv3d bf16 channels_last_3d (cuDNN on the card)"
    a, b = args
    if case.key == "V3":
        a = a.view(TAPS, COUT, CIN).permute(1, 0, 2).reshape(COUT, K)
    elif case.key == "V6":
        a = a[:TAPS * COUT]
    dt = _mm_out_dtype(a.device)
    kw = {"out_dtype": dt} if dt == torch.float32 else {}
    desc = (f"torch.mm ({a.shape[0]}x{a.shape[1]})·({b.shape[0]}x{b.shape[1]}) x{repeats}, "
            f"bf16 in, {'fp32' if dt == torch.float32 else 'bf16'} out")

    def fn():
        for _ in range(repeats):
            out = torch.mm(a, b, **kw)
        return out

    return fn, desc


# ------------------------------------------------------------------ timing ---

def time_ms(fn: Callable, device, reps: int = 5) -> float:
    """Median ms of `reps` calls after one warm-up: CUDA events on the card,
    the host clock on the CPU."""
    fn()
    ts = []
    for _ in range(reps):
        if torch.device(device).type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def run_case(case: Case, device, n: int, repeats: int, seed: int, vx_size: int = 256) -> dict:
    """Time one case: its kernel, its plain version and its cuBLAS yardstick
    (VX/VX2: the cuDNN conv); returns the row of numbers, with the launches
    the kernel's timing added to each counter of ``conv_probe.LAUNCHES``
    (V1's, V0's and V2's show their wgmma instances)."""
    args = make_inputs(case, n, device, seed, vx_size)
    lib, lib_desc = library_call(case, args, repeats)
    b_ms, b_by = bound(case, n, repeats, vx_size)
    row = {"case": case.key, "title": case.title, "kernel": case.kernel,
           "replaces": case.replaces, "n": n, "repeats": repeats,
           "bound_ms": b_ms, "bound_by": b_by, "pass_floor_ms": pass_floor(case, n, repeats),
           "library_call": lib_desc}
    if case.kernel is None:
        row.update(title=case.title.replace("256^3", f"{vx_size}^3"), n=vx_size ** 3,
                   repeats=1, ms=time_ms(lib, device), library_ms=None, plain_ms=None)
    else:
        before = dict(cp.LAUNCHES)
        row["ms"] = time_ms(lambda: case.wrapper(*args, repeats), device)
        row["launches"] = {k: v - before[k] for k, v in cp.LAUNCHES.items() if v != before[k]}
        row["library_ms"] = time_ms(lib, device)
        row["plain_ms"] = time_ms(lambda: case.plain(*args, repeats), device)
    row["tflops"] = operations(case, n, repeats, vx_size) / (row["ms"] * 1e-3) / 1e12
    return row


def format_row(row: dict) -> str:
    floor = "" if row["pass_floor_ms"] is None else f"  per-pass floor {row['pass_floor_ms']:.3f}"
    rest = "" if row["library_ms"] is None else \
        f"  plain {row['plain_ms']:9.3f} ms  cuBLAS {row['library_ms']:9.3f} ms ({row['library_call']})"
    return (f"{row['title']:44s} {row['ms']:9.3f} ms {row['tflops']:7.1f} TF/s  bound "
            f"{row['bound_ms']:.3f} ms ({row['bound_by']}){floor}{rest}")


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def run(cases, device, n: int = N_TOTAL, repeats: int = R, seed: int = 0,
        log=print) -> list[dict]:
    """Run `cases` in order, one line each through `log`; the rows. VX/VX2
    run at 256³ on the card and at 16³ on the CPU."""
    on_card = torch.device(device).type == "cuda"
    rows = []
    for case in cases:
        rows.append(run_case(case, device, n, repeats, seed, 256 if on_card else 16))
        log(format_row(rows[-1]))
        if on_card:
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("prefixes", nargs="*", help="case title prefixes (V1 V0 V2 V3 V3' V5 V6 "
                    "V4 V8 VX VX2); all cases without any")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--repeats", type=int, default=R, help="passes per call (the r axis)")
    ap.add_argument("--n", type=int, default=N_TOTAL, help="spatial columns N")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_conv_probe: no CUDA device (torch.cuda.is_available() is "
                         "False); the probe kernels run only on the card. Pass --device cpu "
                         "to run the plain versions on the host.")
    if args.n < 1 or args.repeats < 1:
        raise SystemExit("bench_conv_probe: --n and --repeats must be ≥ 1")
    if args.device == "cuda":
        device = torch.device("cuda", 0)
        print(f"device: {torch.cuda.get_device_name(0)}; card: {card()}; torch "
              f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    else:
        device = torch.device("cpu")
        print("device: cpu (plain versions; host-clock times, not device metrics)", flush=True)
    print(f"N = {args.n}, R = {args.repeats}, seed {args.seed}; bounds at 989 TFLOP/s and "
          f"3.35 TB/s (H100 SXM)", flush=True)
    rows = run(select(args.prefixes), device, args.n, args.repeats, args.seed,
               log=lambda s: print(s, flush=True))
    print(json.dumps({"device": str(device), "rows": rows}))
    return rows


if __name__ == "__main__":
    main()
