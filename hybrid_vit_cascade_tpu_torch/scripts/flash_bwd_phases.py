"""Where the tensor-core flash backward (kernel D) spends its time, by
ablation.

    python -m hybrid_vit_cascade_tpu_torch.scripts.flash_bwd_phases [--out FILE]

Builds copies of ``csrc/flash_attention_bwd.cu`` with phases of
``flash_bwd_tc_kernel`` switched off (the ordered wait on the previous key
tile, the reads and writes of the dq accumulator, the dq product, the
exp2s) into ``build/flash_bwd_phases/``, one nvcc per variant in parallel,
and times each at the main path's bf16 shapes: the stage-3 self-attention
(8 × 32,768² × 32) and cross-attention (8 × 32,768 × 4,096 × 32). A variant
without a phase computes garbage: the numbers say how long the rest takes,
not what the kernel returns. Prints one line per (shape, variant) with the
median of 5 CUDA-event times, and a JSON record with ``--out``. Needs nvcc
and a CUDA card.
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
from ..ops.cuda import flash_attention as fa

OUT_DIR = _build.BUILD_DIR.parent / "flash_bwd_phases"
# (text in the kernel, its replacement with the switch DIAG & bit)
SWITCHES = {
    1: ("      if (tid == 0) wait_for(cnt, kt);",
        "      if (!(DIAG & 1) && tid == 0) wait_for(cnt, kt);"),
    2: ("        if (row >= nq) continue;", "        if ((DIAG & 2) || row >= nq) continue;"),
    4: ("      for (int kk = 0; kk < kTbKeys / 16; ++kk) {",
        "      for (int kk = 0; kk < ((DIAG & 4) ? 0 : kTbKeys / 16); ++kk) {"),
    8: ("exp2f(fmaf(s[t][e], c, nl[e & 1]))",
        "((DIAG & 8) ? fmaf(s[t][e], c, nl[e & 1]) : exp2f(fmaf(s[t][e], c, nl[e & 1])))"),
}
# DIAG value → what runs
VARIANTS = {0: "all", 1: "no wait", 3: "no wait, no dq add", 7: "no wait, dq add, dq product",
            8: "no exp2", 15: "S, dP, P, dS, dV, dK only"}
SHAPES = [(8, 32768, 32768, 32), (8, 32768, 4096, 32)]


def ablated_source() -> str:
    """The kernel source with each phase behind a bit of the DIAG macro."""
    src = (_build.CSRC_DIR / "flash_attention_bwd.cu").read_text()
    for bit, (old, new) in SWITCHES.items():
        if src.count(old) != 1:
            raise RuntimeError(f"phase switch {bit} does not match the kernel: {old!r}")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the record as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("flash_bwd_phases: needs a CUDA card")
    libs = build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    record = {"card": torch.cuda.get_device_name(0), "ms": {}}
    for bh, nq, nk, d in SHAPES:
        q, dout = (torch.randn((bh, nq, d), generator=gen, device=dev).bfloat16() for _ in range(2))
        k, v = (torch.randn((bh, nk, d), generator=gen, device=dev).bfloat16() for _ in range(2))
        out, lse = fa.flash_attention_fwd(q, k, v, d ** -0.5)
        delta = (dout.float() * out.float()).sum(-1)
        n_acc, n_cnt = fa.bwd_tc_scratch(bh, nq, d)
        acc = torch.empty((n_acc,), device=dev)
        counters = torch.empty((n_cnt,), dtype=torch.int32, device=dev)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        for var, name in VARIANTS.items():
            fn = getattr(libs[var], "hvc_flash_attention_bwd")
            fn.argtypes = list(fa._FUSED_ARGTYPES)
            fn.restype = ctypes.c_int
            stream = torch.cuda.current_stream(dev).cuda_stream

            def call():
                counters.zero_()
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                        delta.data_ptr(), acc.data_ptr(), counters.data_ptr(), dq.data_ptr(),
                        dk.data_ptr(), dv.data_ptr(), bh, nq, nk, d, 1, 1, d ** -0.5, stream)
                _build.check(rc, f"flash_bwd_phases DIAG={var}")

            call()
            times = []
            for _ in range(5):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                call()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            ms = statistics.median(times)
            record["ms"][f"{(bh, nq, nk, d)}, {name}"] = ms
            print(f"{(bh, nq, nk, d)} DIAG={var:2d} ({name}): {ms:.3f} ms", flush=True)
        del q, k, v, dout, out, lse, delta, acc, dq, dk, dv
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
