"""What the stride-2 tensor-core conv's weight layout costs and buys.

    python -m hybrid_vit_cascade_tpu_torch.scripts.conv_s2_weights [--out FILE]

``conv_tc_s2_kernel`` (kernels C/I, ``csrc/conv3d_k3.cu``) reads its
weights in ``conv3d_k3.s2_tc_weights``'s layout, which the wrapper makes on
every call, so a chunk's weights are one contiguous cp.async copy. The other
way is to stage them from w itself, 27 two-byte loads per (co, ci) as
``conv_tc_kernel`` does at stride 1. This script builds a copy of
``csrc/conv3d_k3.cu`` twice into ``build/conv_s2_weights/`` (one nvcc each,
in parallel): as it is (DIAG=0), and with the weight copy replaced by that
staging from w (DIAG=1). At each main-path stride-2 shape on the tensor
cores (bf16, dense) it times, as the median of 7 CUDA-event times: the
wrapper ``conv3d_k3(..., dense=True)`` (rearrangement and kernel, as the
model calls it), ``s2_tc_weights`` alone, the kernel alone from the
rearranged weights, and the variant from w. The two kernels' outputs must be
bitwise equal. Prints one line per shape and a JSON record with ``--out``.
Needs nvcc and a CUDA card.
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

OUT_DIR = _build.BUILD_DIR.parent / "conv_s2_weights"
# (text in the kernel, its replacement: DIAG 1 stages [tap][co][ci] from w,
# which the caller then passes in wtc's place)
SWITCHES = {
    1: ("""    const bf16* wsrc = wtc + (static_cast<long long>(cot) * n_ci + ch) * kS2Wts;
    for (int u = tid; u < kS2Wts / 8; u += kS2Threads)
      cp_async16(wts + s2_swz(u >> 1, u & 1), wsrc + u * 8, 16);
""", """#if DIAG & 1
    for (int u = tid; u < kS2Co * kS2Ci; u += kS2Threads) {
      const int k = u % kS2Ci, co = u / kS2Ci;
      const int ci = ci0 + k, oc = co0 + co;
      const bool ok = ci < cin && oc < cout;
      const unsigned short* src = reinterpret_cast<const unsigned short*>(wtc) +
                                  (ok ? (static_cast<long long>(oc) * cin + ci) * 27 : 0);
      unsigned short* wsm = reinterpret_cast<unsigned short*>(wts);
#pragma unroll
      for (int tap = 0; tap < 27; ++tap)
        wsm[s2_swz(tap * kS2Co + co, k >> 3) + (k & 7)] = ok ? src[tap] : 0;
    }
#else
    const bf16* wsrc = wtc + (static_cast<long long>(cot) * n_ci + ch) * kS2Wts;
    for (int u = tid; u < kS2Wts / 8; u += kS2Threads)
      cp_async16(wts + s2_swz(u >> 1, u & 1), wsrc + u * 8, 16);
#endif
"""),
}
VARIANTS = {0: "rearranged weights", 1: "staged from w"}
# (B, Cin, Cout, (D, H, W)): the stride-2 convs of the main path on the
# tensor cores (chip_smoke.py KERNELS["conv3d_k3s2"], the 1→64 stem excepted)
SHAPES = [(1, 32, 64, (256, 256, 256)), (1, 64, 128, (128, 128, 128)),
          (1, 128, 256, (64, 64, 64)), (1, 32, 64, (128, 128, 128)),
          (1, 64, 128, (64, 64, 64)), (1, 64, 128, (32, 32, 32)), (1, 128, 256, (32, 32, 32))]


def ablated_source() -> str:
    """The kernel source with the weight staging behind a bit of DIAG."""
    src = (_build.CSRC_DIR / "conv3d_k3.cu").read_text()
    for bit, (old, new) in SWITCHES.items():
        if src.count(old) != 1:
            raise RuntimeError(f"switch {bit} does not match the kernel: {old!r}")
        src = src.replace(old, new)
    return src


def build() -> dict:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "k.cu").write_text(ablated_source())
    for h in _build.headers():
        (OUT_DIR / h.name).write_text(h.read_text())
    nvcc = _build.find_nvcc()
    procs = {v: subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-shared", f"-DDIAG={v}", "-o",
                                  str(OUT_DIR / f"k{v}.so"), str(OUT_DIR / "k.cu")],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for v in VARIANTS}
    libs = {}
    for v, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for DIAG={v}:\n{out}")
        libs[v] = ctypes.CDLL(str(OUT_DIR / f"k{v}.so"))
    return libs


def _median_ms(fn, reps: int = 7) -> float:
    fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the record as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("conv_s2_weights: needs a CUDA card")
    libs = build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    record = {"card": torch.cuda.get_device_name(0), "ms": {}}
    for B, cin, cout, (D, H, W) in SHAPES:
        assert ck.fwd_uses_tensor_cores(torch.bfloat16, 2, cin, cout)
        x = torch.randn((B, cin, D, H, W), generator=gen, device=dev).bfloat16()
        w = (torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev) * 0.05).bfloat16()
        bias = torch.zeros(cout, device=dev)
        d_out = (D - 1) // 2 + 1
        wtc = ck.s2_tc_weights(w)
        outs = {}

        def kernel(v, wts):
            fn = getattr(libs[v], "hvc_conv3d_k3s2_fwd")
            fn.argtypes = list(ck._FWD_S2_ARGTYPES)
            fn.restype = ctypes.c_int
            out = torch.empty((B, cout, d_out, (H - 1) // 2 + 1, (W - 1) // 2 + 1),
                              dtype=torch.bfloat16, device=dev)
            outs[v] = out

            def call():
                rc = fn(x.data_ptr(), w.data_ptr(), wts.data_ptr(), bias.data_ptr(),
                        out.data_ptr(), B, cin, cout, D, H, W, d_out, 1, x.stride(0),
                        x.stride(1), 0, 0, None, 0, 0, None, None, 1, stream)
                _build.check(rc, f"conv_s2_weights DIAG={v}")
            return call

        row = {"wrapper": _median_ms(lambda: ck.conv3d_k3(x, w, bias, 2, 1, d_out, dense=True)),
               "s2_tc_weights": _median_ms(lambda: ck.s2_tc_weights(w)),
               "kernel, rearranged weights": _median_ms(kernel(0, wtc)),
               "kernel, staged from w": _median_ms(kernel(1, w))}
        torch.cuda.synchronize()
        if not torch.equal(outs[0], outs[1]):
            raise AssertionError(f"{cin}→{cout} at {D}³: the two weight stagings disagree")
        key = f"{cin}→{cout} from {D}³"
        record["ms"][key] = row
        print(key + ": " + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items()), flush=True)
        del x, w, wtc, outs
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
