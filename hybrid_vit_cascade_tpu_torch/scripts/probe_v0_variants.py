"""The V0 probe control (``make_v1`` at m = 256) on each instance of ``make_v1``.

    python -m hybrid_vit_cascade_tpu_torch.scripts.probe_v0_variants [--out FILE]

Times, in turns, out (256, N) fp32 = W (256, 1728) · P (1728, N) over R = 64
passes (``hvc_probe_v1_instance`` of ``csrc/conv_probe.cu``, bf16 in) on

- (a) the 128 × 128 mma.sync instance as it walks, every N tile of M tile 0
  before any of M tile 1 (what V0 ran on before the wgmma instance);
- (b) the same instance with the M tiles of an N tile walked together (its
  M_INNER template flag), so the blocks in flight share P tiles;
- (c) the wgmma instance (``probe_gemm_wgmma``: 256 rows × 128 columns a
  work item, TMA into a four-chunk ring), which ``make_v1`` takes for V0;

and one cuBLAS call over the same operands (``torch.mm``, R calls, fp32 out)
as the yardstick, at N = 131,072 (P, 453 MB, streams from device memory
every pass) and at N = 8,192 (P, 28 MB, stays in the 50 MB L2: the rate the
products sustain, beside the 989 TFLOP/s dense bf16 peak). Each variant is
first held to the plain product (fp32, one pass) within 1e-4·max|want| +
1e-4·|want|. Prints the card's name and power limit, one line per (N,
variant) with the median of 5 CUDA-event times and its TFLOP/s, and a JSON
record with ``--out``. Needs nvcc and a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

import torch

from ..ops.cuda import _build
from ..ops.cuda import conv_probe as cp

M, K, R = 256, cp.K, 64
SIZES = (131072, 8192)
PEAK_TFLOPS = 989.0  # H100 SXM dense bf16
VARIANTS = {0: "(a) mma.sync 128 x 128, N tiles of M tile 0 first",
            1: "(b) mma.sync 128 x 128, M tiles of an N tile together",
            2: "(c) wgmma 256 x 128, TMA ring"}
TOL = (1e-4, 1e-4)
_P, _I = ctypes.c_void_p, ctypes.c_int
# hvc_probe_v1_instance(w, p, out, m, k, n, repeats, aligned, instance, stream)
_ARGTYPES = (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P)


def _time(call) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the record as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("probe_v0_variants: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    fn = _build.function("hvc_probe_v1_instance", _ARGTYPES)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    record = {"card": card, "m": M, "k": K, "repeats": R, "ms": {}, "tflops": {}, "max_abs_err": {}}
    stream = torch.cuda.current_stream(dev).cuda_stream
    for n in SIZES:
        w = torch.randn((M, K), generator=gen, device=dev, dtype=torch.bfloat16)
        p = torch.randn((K, n), generator=gen, device=dev, dtype=torch.bfloat16)
        want = cp.probe_v1_plain(w, p, 1)
        atol, rtol = TOL
        calls = {}
        for v, name in VARIANTS.items():
            out = torch.empty((M, n), dtype=torch.float32, device=dev)

            def call(v=v, out=out):
                _build.check(fn(w.data_ptr(), p.data_ptr(), out.data_ptr(), M, K, n, R, 1, v,
                                stream), f"probe_v0_variants {VARIANTS[v]}")

            call()
            torch.cuda.synchronize()
            diff = (out - want).abs()
            err = float(diff.max())
            record["max_abs_err"][f"N={n} {name}"] = err
            if not bool((diff <= atol * float(want.abs().max()) + rtol * want.abs()).all()):
                raise AssertionError(f"{name} at N={n} disagrees with the plain product: {err}")
            calls[name] = call
        calls["cuBLAS torch.mm x64, fp32 out"] = \
            lambda: [torch.mm(w, p, out_dtype=torch.float32) for _ in range(R)]
        times = {name: [] for name in calls}
        for name, call in calls.items():  # warm-up
            call()
        for _ in range(5):
            for name, call in calls.items():
                times[name].append(_time(call))
        flops = 2.0 * R * M * K * n
        for name, ts in times.items():
            ms = statistics.median(ts)
            tf = flops / (ms * 1e-3) / 1e12
            record["ms"][f"N={n} {name}"] = ms
            record["tflops"][f"N={n} {name}"] = tf
            print(f"N={n:6d} R={R} {name:52s} {ms:9.3f} ms {tf:7.1f} TF/s "
                  f"({100 * tf / PEAK_TFLOPS:.1f}% of {PEAK_TFLOPS:g})", flush=True)
        del w, p, want, calls
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
