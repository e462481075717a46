"""The one-input-channel tensor-core kernels against variants of themselves.

    python -m hybrid_vit_cascade_tpu_torch.scripts.c1in_variants [--out FILE]

Builds copies of ``csrc/conv3d_k3.cu`` and ``csrc/conv3d_k3_bwd.cu`` with
parts of ``conv_c1in_tc_kernel`` and ``wgrad_c1in_tc_kernel`` switched by the
bits of a DIAG macro into ``build/c1in_variants/``, one nvcc per variant in
parallel, and times each, in turns, at the bf16 1→64 and 1→32 convs over
256³ (dense, qlo 1):

- the forward: as it is; writing bf16 pairs straight from the accumulator
  fragments instead of through the warp's shared tile (4-byte stores, 16
  bytes of a row a quad); without the global stores (what staging, products
  and the shared tile take);
- the weight gradient: as it is (Cout as M, taps as N); the other
  orientation, taps as M (27 of 32 rows) and Cout as N, from the same staged
  tiles; without the products; without the copies of g.

A variant that drops work computes garbage: its time says how long the rest
takes. The two full variants (direct stores, taps as M) must give what the
kernel gives; the script prints their largest difference. Prints one line
per (shape, variant) with the median of 5 CUDA-event times, and a JSON
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
from ..ops.cuda import conv3d_k3 as ck

OUT_DIR = _build.BUILD_DIR.parent / "c1in_variants"
# (text in the kernel, its replacement under the DIAG bits), by what it switches
SWITCHES = {
    "conv3d_k3.cu": {
        "direct stores": ("""          *reinterpret_cast<uint32_t*>(otw + (mt * 16 + (lane >> 2) + half * 8) * kCiOld + 8 * q +
                                       2 * (lane & 3)) = pk;""",
            """          if (DIAG & 1) {
            const int co = co0 + mt * 16 + (lane >> 2) + half * 8;
            if (ok1 && co < cout)
              *reinterpret_cast<uint32_t*>(out + (b * cout + co) * ovol + od * oplane +
                                           static_cast<long long>(oh) * W + ow) = pk;
          } else {
            *reinterpret_cast<uint32_t*>(otw + (mt * 16 + (lane >> 2) + half * 8) * kCiOld +
                                         8 * q + 2 * (lane & 3)) = pk;
          }"""),
        "no shared-tile stores": ("    for (int it = 0; it < MT; ++it) {\n      const int row = it * 16 + st_row",
            "    for (int it = 0; it < ((DIAG & 3) ? 0 : MT); ++it) {\n"
            "      const int row = it * 16 + st_row"),
    },
    "conv3d_k3_bwd.cu": {
        "taps as M, row": ("  const int wofs = vz * kW1Plane + vy * kW1Row + c0 + 8 * ((lane >> 3) & 1);",
            "  const int wofs = vz * kW1Plane + vy * kW1Row + c0 +\n"
            "                   8 * ((DIAG & 4) ? (lane >> 4) : ((lane >> 3) & 1));"),
        "taps as M, tap": ("    const int tap = 16 * p + (lane & 7) + 8 * (lane >> 4);",
            "    const int tap = (DIAG & 4) ? 16 * p + (lane & 15) : 16 * p + (lane & 7) + 8 * (lane >> 4);"),
        "taps as M, products": ("""      uint32_t a[2][4], bfr[2][4];
      load_a(a[0], gt, kW1Gld, 0, k0, lane);""",
             """      if (DIAG & 4) {  // taps as M (A from the copies), Cout as N (B from g)
        uint32_t ta[2][4], gb[2][4];
        ldsm_x4(ta[0], lrow[0] + 16 * kk);
        ldsm_x4(ta[1], lrow[1] + 16 * kk);
#pragma unroll
        for (int p = 0; p < 2; ++p)
          ldsm_x4(gb[p], gt + (16 * p + (lane & 7) + 8 * (lane >> 4)) * kW1Gld + k0 +
                             8 * ((lane >> 3) & 1));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            mma16816(acc[mt][2 * p], ta[mt], gb[p][0], gb[p][1]);
            mma16816(acc[mt][2 * p + 1], ta[mt], gb[p][2], gb[p][3]);
          }
        continue;
      }
      uint32_t a[2][4], bfr[2][4];
      load_a(a[0], gt, kW1Gld, 0, k0, lane);"""),
        "taps as M, flush": ("""                const int co = mt * 16 + (lane >> 2) + (f >> 1) * 8;
                const int tap = nt * 8 + (lane & 3) * 2 + (f & 1);""",
             """                const int co = (DIAG & 4) ? nt * 8 + (lane & 3) * 2 + (f & 1)
                                          : mt * 16 + (lane >> 2) + (f >> 1) * 8;
                const int tap = (DIAG & 4) ? mt * 16 + (lane >> 2) + (f >> 1) * 8
                                           : nt * 8 + (lane & 3) * 2 + (f & 1);"""),
        "no products": ("    for (int kk = 0; kk < 2; ++kk) {\n      const int k0",
             "    for (int kk = 0; kk < ((DIAG & 8) ? 0 : 2); ++kk) {\n      const int k0"),
        "no copies of g": ("    for (int u = tid; u < kW1Co * kW1Td * kW1Th * (kW1Tw / 8); u += kW1Threads) {",
              "    for (int u = tid; u < ((DIAG & 16) ? 0 : kW1Co * kW1Td * kW1Th * (kW1Tw / 8));\n"
              "         u += kW1Threads) {"),
    },
}
# DIAG value → what runs, per source
VARIANTS = {"conv3d_k3.cu": {0: "as it is", 1: "direct stores", 2: "no global stores"},
            "conv3d_k3_bwd.cu": {0: "as it is", 4: "taps as M", 8: "no products",
                                 16: "no copies of g"}}
# the variants that must give the kernel's result
FULL = {("conv3d_k3.cu", 1), ("conv3d_k3_bwd.cu", 4)}
COUTS = (64, 32)
SIZE = 256
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def ablated_source(name: str) -> str:
    """The kernel source with each variant behind its DIAG bits."""
    src = (_build.CSRC_DIR / name).read_text()
    for what, (old, new) in SWITCHES[name].items():
        if src.count(old) != 1:
            raise RuntimeError(f"switch '{what}' of {name} does not match the kernel: {old!r}")
        src = src.replace(old, new)
    return src


def build() -> dict:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for h in _build.headers():
        (OUT_DIR / h.name).write_text(h.read_text())
    nvcc = _build.find_nvcc()
    procs = {}
    for name, variants in VARIANTS.items():
        (OUT_DIR / name).write_text(ablated_source(name))
        for v in variants:
            lib = OUT_DIR / f"{name.split('.')[0]}_{v}.so"
            procs[(name, v)] = (lib, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-shared", f"-DDIAG={v}", "-o", str(lib),
                 str(OUT_DIR / name)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


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
        sys.exit("c1in_variants: needs a CUDA card")
    libs = build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    record = {"card": torch.cuda.get_device_name(0), "ms": {}, "max_diff": {}}
    n = SIZE
    x = torch.randn((1, 1, n, n, n), generator=gen, device=dev).bfloat16()
    for cout in COUTS:
        w = (torch.randn((cout, 1, 3, 3, 3), generator=gen, device=dev) / 27 ** 0.5).bfloat16()
        bias = torch.randn((cout,), generator=gen, device=dev)
        g = torch.randn((1, cout, n, n, n), generator=gen, device=dev).bfloat16()
        splits = ck.wgrad_plan((1, 1, n, n, n), cout, 1, torch.bfloat16, sms)[1]
        part = torch.empty((splits, cout, 1, 27), device=dev)
        calls, outs = {}, {}
        stream = torch.cuda.current_stream(dev).cuda_stream
        for (name, v), lib in libs.items():
            if name == "conv3d_k3.cu":
                fn = lib.hvc_conv3d_k3s1_fwd
                fn.argtypes = [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _L, _L, _I, _I, _P,
                               _L, _L, _P, _P, _I, _P]
                out = torch.empty((1, cout, n, n, n), dtype=torch.bfloat16, device=dev)
                args_ = (x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), 1, 1, cout,
                         n, n, n, n, 1, x.stride(0), x.stride(1), 0, 0, None, 0, 0, None, None, 1,
                         stream)
            else:
                fn = lib.hvc_conv3d_k3s1_wgrad
                fn.argtypes = [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _L, _L, _I, _I, _I,
                               _P]
                out = torch.empty((cout, 1, 3, 3, 3), device=dev)
                args_ = (x.data_ptr(), g.data_ptr(), part.data_ptr(), out.data_ptr(), 1, 1, cout,
                         n, n, n, n, 1, x.stride(0), x.stride(1), 0, 1, splits, stream)
            fn.restype = _I

            def call(fn=fn, args_=args_, key=(name, v)):
                _build.check(fn(*args_), f"c1in_variants {key}")

            calls[(name, v)], outs[(name, v)] = call, out
            call()
        torch.cuda.synchronize()
        for name, v in FULL:
            diff = float((outs[(name, v)].float() - outs[(name, 0)].float()).abs().max())
            record["max_diff"][f"1→{cout} {name} {VARIANTS[name][v]}"] = diff
            print(f"1→{cout} {name} {VARIANTS[name][v]}: max |diff| against the kernel {diff:.3e}",
                  flush=True)
        times = {key: [] for key in calls}
        for _ in range(5):
            for key, call in calls.items():
                times[key].append(_time(call))
        for (name, v), ts in times.items():
            ms = statistics.median(ts)
            record["ms"][f"1→{cout} {name} {VARIANTS[name][v]}"] = ms
            print(f"1→{cout} at {n}³ {name:17s} DIAG={v:3d} ({VARIANTS[name][v]}): {ms:.3f} ms",
                  flush=True)
        del g, outs, part
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
