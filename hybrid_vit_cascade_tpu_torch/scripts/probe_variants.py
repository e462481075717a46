"""The V0-V4 and V6 conv probes on each of their instances, beside cuBLAS.

    python -m hybrid_vit_cascade_tpu_torch.scripts.probe_variants [V0 V1 V2 V3 V4 V6]
        [--sizes N ...] [--out FILE]

Times, in turns, over R = 64 passes (bf16 in, fp32 out; the instances of
``hvc_probe_v1_instance``, ``hvc_probe_v2_instance``,
``hvc_probe_v3_instance``, ``hvc_probe_v4_instance`` and
``hvc_probe_v6_instance`` in ``csrc/conv_probe.cu``):

- V0, ``make_v1`` at m = 256: out (256, N) = W (256, 1728) · P (1728, N) on
  (a) the 128 × 128 mma.sync instance as it walks, every N tile of M tile 0
  before any of M tile 1; (b) the same with the M tiles of an N tile walked
  together (its M_INNER flag); (c) the wgmma instance ``make_v1`` takes
  (WgV0: 256 rows × 128 columns a work item);
- V1, ``make_v1`` at m = 32: out (32, N) = W (32, 1728) · P (1728, N) on (a)
  the 32 × 128 mma.sync instance it took before wgmma and still takes at a
  ragged N; (b) the wgmma instance it takes (WgV1: W's 32 rows the top half
  of one m64 tile, 256 columns a work item);
- V2, ``v2``: out (N, 32) = Pᵀ (N, 1728) · Wᵀ (1728, 32) on (a) the 128 × 32
  mma.sync instance it took before wgmma; (b) the wgmma instance it takes
  (WgV2: Wᵀ resident in shared memory, a three-chunk ring); (c) the same with
  a 4 KB chunk of W streamed beside each chunk of Pᵀ instead (WgV2Streamed,
  a five-chunk ring; W passed transposed, 32 × 1728);
- V3, ``v3``: out (32, N) = Σ_{t<27} W27[32t:32t+32] · P[64t:64t+64] on (a)
  the 32 × 128 mma.sync instance it took before wgmma and still takes at a
  ragged N; (b) the wgmma instance it takes (WgV3: V1's, with K chunk t's A
  box the 64 rows of W27 from row 32t);
- V4, ``v4``: out (32, N) = the 27 row groups of W27 (864, 64) · X (64, N)
  summed, on (a) ``probe_tapsum``, the mma.sync instance it took before
  wgmma and still takes at a ragged N (32 × 32 tiles, 9 × 2 warps, the
  warps' partial sums added through shared memory); (b) the wgmma instance
  it takes (WgV4: W27 resident as A, two taps to an m64 tile, one
  accumulator chain, 128 columns a work item, three ring stages a
  consumer);
- V6, ``v6``: the same sum as 7 dots of M = 128 over W27p (896, 64), on (a)
  ``probe_tapsum`` (32 × 64 tiles, 4 × 2 warps); (b) the wgmma instance it
  takes (WgV6: two accumulator chains, tiles 2g and 2g + 1 of dot g, 128
  columns a work item);

each beside one cuBLAS call over the same operands (``torch.mm``, R calls,
fp32 out; V3's W27 laid out as V1's 32 × 1728 W; V4's and V6's product
without the tap sum, (864 × 64)·(64 × N)) as the yardstick, at N = 131,072
(P, 453 MB, streams from device memory every pass; V4's and V6's X, 16.8
MB, stays in L2) and at N = 8,192 (P, 28 MB, stays in the 50 MB L2: the
rate at which the instance stages and multiplies it), or at the N of
``--sizes`` (a larger N leaves a smaller share of P in the L2 from one pass
to the next). Each instance is first
held to the plain product (fp32, one pass) within 1e-4·max|want| +
1e-4·|want|. Prints the card's name and power limit, one line per (case, N,
variant) with the median of 5 CUDA-event times, its TFLOP/s (the probes'
count, 2·32·1728·N a pass; V0 8×) and its rate of bytes (each input read
once a pass, the output written once a pass), and a JSON record with
``--out``. Needs nvcc and a CUDA card.
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
from . import bench_conv_probe as bench

K, R = cp.K, 64
SIZES = (131072, 8192)
PEAK_TFLOPS = 989.0  # H100 SXM dense bf16
PEAK_TBS = 3.35      # H100 SXM HBM3
TOL = (1e-4, 1e-4)
_P, _I = ctypes.c_void_p, ctypes.c_int
# hvc_probe_v1_instance(w, p, out, m, k, n, repeats, aligned, instance, stream)
_V1_ARGTYPES = (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
# hvc_probe_v2_instance(pt, w, out, k, n, repeats, instance, stream)
_V2_ARGTYPES = (_P, _P, _P, _I, _I, _I, _I, _P)
# hvc_probe_{v3,v4,v6}_instance(w, x, out, n, repeats, aligned, instance, stream)
_TAP_ARGTYPES = (_P, _P, _P, _I, _I, _I, _I, _P)
# (case, m of the product, {instance code: name})
CASES = {
    "V0": (256, {1: "(a) mma.sync 128 x 128, N tiles of M tile 0 first",
                 4: "(b) mma.sync 128 x 128, M tiles of an N tile together",
                 2: "(c) wgmma 256 x 128, TMA ring"}),
    "V1": (32, {0: "(a) mma.sync 32 x 128",
                3: "(b) wgmma m64 (32 rows) x 256, TMA ring"}),
    "V2": (32, {0: "(a) mma.sync 128 x 32",
                1: "(b) wgmma 256 x 32, W^T resident",
                2: "(c) wgmma 256 x 32, W chunks streamed"}),
    "V3": (32, {0: "(a) mma.sync 32 x 128",
                1: "(b) wgmma m64 (32 rows) x 256, W27 tap-major"}),
    "V4": (32, {0: "(a) mma.sync 32 x 32, 9 x 2 warps",
                1: "(b) wgmma 32 x 128, W resident, 1 chain"}),
    "V6": (32, {0: "(a) mma.sync 32 x 64, 4 x 2 warps",
                1: "(b) wgmma 32 x 128, W resident, 2 chains"}),
}


def _time(call) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _calls(case: str, m: int, n: int, dev, gen, stream) -> tuple[dict, dict, torch.Tensor]:
    """({name: call} of the case's instances and its cuBLAS yardstick, {name:
    max |err|}, the plain product); each instance checked once."""
    names = CASES[case][1]
    if case == "V2":
        pt = torch.randn((n, K), generator=gen, device=dev, dtype=torch.bfloat16)
        wt = torch.randn((K, m), generator=gen, device=dev, dtype=torch.bfloat16)
        w32 = wt.t().contiguous()
        want = cp.probe_v2_plain(pt, wt, 1)
        fn = _build.function("hvc_probe_v2_instance", _V2_ARGTYPES)
        out_shape = (n, m)

        def run(v, out):
            b = w32 if v == 2 else wt
            _build.check(fn(pt.data_ptr(), b.data_ptr(), out.data_ptr(), K, n, R, v, stream),
                         f"probe_variants V2 {names[v]}")

        lib = lambda: [torch.mm(pt, wt, out_dtype=torch.float32) for _ in range(R)]  # noqa: E731
    elif case in ("V3", "V4", "V6"):
        c = bench.BY_KEY[case]
        w27 = torch.randn(c.w_shape, generator=gen, device=dev, dtype=torch.bfloat16)
        p = torch.randn((c.x_rows, n), generator=gen, device=dev, dtype=torch.bfloat16)
        w = w27.view(cp.TAPS, m, cp.CIN).permute(1, 0, 2).reshape(m, K) if case == "V3" \
            else w27[:cp.TAPS * m]
        want = c.plain(w27, p, 1)
        fn = _build.function(f"hvc_probe_{case.lower()}_instance", _TAP_ARGTYPES)
        out_shape = (m, n)

        def run(v, out):
            _build.check(fn(w27.data_ptr(), p.data_ptr(), out.data_ptr(), n, R, 1, v, stream),
                         f"probe_variants {case} {names[v]}")

        lib = lambda: [torch.mm(w, p, out_dtype=torch.float32) for _ in range(R)]  # noqa: E731
    else:
        w = torch.randn((m, K), generator=gen, device=dev, dtype=torch.bfloat16)
        p = torch.randn((K, n), generator=gen, device=dev, dtype=torch.bfloat16)
        want = cp.probe_v1_plain(w, p, 1)
        fn = _build.function("hvc_probe_v1_instance", _V1_ARGTYPES)
        out_shape = (m, n)

        def run(v, out):
            _build.check(fn(w.data_ptr(), p.data_ptr(), out.data_ptr(), m, K, n, R, 1, v, stream),
                         f"probe_variants {case} {names[v]}")

        lib = lambda: [torch.mm(w, p, out_dtype=torch.float32) for _ in range(R)]  # noqa: E731
    calls, errs = {}, {}
    atol, rtol = TOL
    for v, name in names.items():
        out = torch.empty(out_shape, dtype=torch.float32, device=dev)
        call = (lambda v=v, out=out: run(v, out))
        call()
        torch.cuda.synchronize()
        diff = (out - want).abs()
        errs[name] = float(diff.max())
        if not bool((diff <= atol * float(want.abs().max()) + rtol * want.abs()).all()):
            raise AssertionError(f"{case} {name} at N={n} disagrees with the plain product: "
                                 f"{errs[name]}")
        calls[name] = call
    calls["cuBLAS torch.mm x64, fp32 out"] = lib
    return calls, errs, want


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cases", nargs="*", help=f"cases of {', '.join(CASES)} (all without any)")
    ap.add_argument("--sizes", type=int, nargs="+", default=list(SIZES), help="columns N")
    ap.add_argument("--out", help="write the record as JSON here")
    args = ap.parse_args(argv)
    if set(args.cases) - set(CASES):
        ap.error(f"unknown cases {sorted(set(args.cases) - set(CASES))}")
    if not torch.cuda.is_available():
        sys.exit("probe_variants: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    record = {"card": card, "k": K, "repeats": R, "ms": {}, "tflops": {}, "tbs": {},
              "max_abs_err": {}}
    for case in args.cases or list(CASES):
        m = CASES[case][0]
        for n in args.sizes:
            calls, errs, _ = _calls(case, m, n, dev, gen, stream)
            record["max_abs_err"].update({f"{case} N={n} {k}": e for k, e in errs.items()})
            times = {name: [] for name in calls}
            for call in calls.values():  # warm-up
                call()
            for _ in range(5):
                for name, call in calls.items():
                    times[name].append(_time(call))
            flops = bench.operations(bench.BY_KEY[case], n, R)
            nbytes = R * bench.nbytes(bench.BY_KEY[case], n)
            for name, ts in times.items():
                ms = statistics.median(ts)
                tf, tbs = flops / (ms * 1e-3) / 1e12, nbytes / (ms * 1e-3) / 1e12
                key = f"{case} N={n} {name}"
                record["ms"][key], record["tflops"][key], record["tbs"][key] = ms, tf, tbs
                print(f"{case} N={n:6d} R={R} {name:40s} {ms:9.3f} ms {tf:7.1f} TF/s "
                      f"({100 * tf / PEAK_TFLOPS:.1f}% of {PEAK_TFLOPS:g}) {tbs:5.2f} TB/s "
                      f"({100 * tbs / PEAK_TBS:.1f}% of {PEAK_TBS:g})", flush=True)
            del calls
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
