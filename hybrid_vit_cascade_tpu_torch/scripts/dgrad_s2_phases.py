"""Where the tensor-core stride-2 data gradient (F/J) spends its time, by
ablation.

    python -m hybrid_vit_cascade_tpu_torch.scripts.dgrad_s2_phases [--out FILE]

Builds copies of ``csrc/conv3d_k3_bwd.cu`` with phases of
``dgrad_s2_tc_kernel`` switched off (the products, the cp.async copies of
the next chunk's weights and of its g rows, the register transpose of the g
rows into the patch, the accumulators' move into the epilogue tile, the dx
stores; the first chunk's copies always run) into
``build/dgrad_s2_phases/``, one nvcc per variant in parallel, and times
each kernel alone (weights pre-arranged by ``s2_dgrad_tc_weights`` once) at
the main path's dense bf16 shapes 32→64 from 256³ and 64→128 from 128³. A
variant without a phase computes garbage: the numbers say how long the rest
takes, not what the kernel returns. Prints one line per (shape, variant)
with the median of 5 CUDA-event times, and a JSON record with ``--out``.
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

OUT_DIR = _build.BUILD_DIR.parent / "dgrad_s2_phases"
# (text in the kernel, its replacement with the switch DIAG & bit). The move
# of the accumulators into the epilogue tile (16) is skipped by a condition
# the compiler cannot decide (cin > 0 always holds), so the products that
# feed it are still compiled in.
SWITCHES = {
    1: ("    const bf16* wts = wbuf + (ch & 1) * kDtWts;\n    if (grp1) {",
        "    const bf16* wts = wbuf + (ch & 1) * kDtWts;\n    if (DIAG & 1) {\n    } else if (grp1) {"),
    2: ("      issue_w(ch + 1, wbuf + ((ch + 1) & 1) * kDtWts);",
        "      if (!(DIAG & 2)) issue_w(ch + 1, wbuf + ((ch + 1) & 1) * kDtWts);"),
    4: ("      issue_g(ch + 1, graw + ((ch + 1) & 1) * kDtGraw);",
        "      if (!(DIAG & 4)) issue_g(ch + 1, graw + ((ch + 1) & 1) * kDtGraw);"),
    8: ("    transpose_g(graw + (ch & 1) * kDtGraw);",
        "    if (!(DIAG & 8)) transpose_g(graw + (ch & 1) * kDtGraw);"),
    16: ("  __syncthreads();  // the staging buffers are no longer read: the epilogue tile takes them\n"
         "  if (grp1) {",
         "  __syncthreads();  // the staging buffers are no longer read: the epilogue tile takes them\n"
         "  if ((DIAG & 16) && cin > 0) {\n  } else if (grp1) {"),
    32: ("  for (int u = tid; u < kDtCi * kDtVox / 8; u += kDtThreads) {",
         "  for (int u = tid; u < ((DIAG & 32) ? 0 : kDtCi * kDtVox / 8); u += kDtThreads) {"),
}
# DIAG value → what runs
VARIANTS = {0: "all", 1: "no products", 2: "no weight copies", 4: "no g copies",
            14: "no staging after the first chunk", 32: "no dx stores", 48: "no epilogue",
            62: "products only", 49: "staging only"}
# (B, Cin, Cout, (D, H, W)) of the forward conv, dense
SHAPES = [(1, 32, 64, (256, 256, 256)), (1, 64, 128, (128, 128, 128))]


def ablated_source() -> str:
    """The kernel source with each phase behind a bit of the DIAG macro."""
    src = (_build.CSRC_DIR / "conv3d_k3_bwd.cu").read_text()
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
        sys.exit("dgrad_s2_phases: needs a CUDA card")
    libs = build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    record = {"card": torch.cuda.get_device_name(0), "ms": {}}
    for b, cin, cout, dhw in SHAPES:
        odhw = tuple((n - 1) // 2 + 1 for n in dhw)
        g = torch.randn((b, cout, *odhw), generator=gen, device=dev).bfloat16()
        w = (torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev) / (27 * cin) ** 0.5)
        w = w.bfloat16()
        wtc = ck.s2_dgrad_tc_weights(w)
        dx = torch.empty((b, cin, *dhw), dtype=torch.bfloat16, device=dev)
        for v, name in VARIANTS.items():
            fn = getattr(libs[v], "hvc_conv3d_k3s2_dgrad")
            fn.argtypes = list(ck._DGRAD_ARGTYPES)
            fn.restype = ctypes.c_int
            stream = torch.cuda.current_stream(dev).cuda_stream

            def call():
                rc = fn(g.data_ptr(), w.data_ptr(), wtc.data_ptr(), dx.data_ptr(), b, cin, cout,
                        dhw[0], dhw[1], dhw[2], odhw[0], 1, 0, None, 0, 0, 1, stream)
                _build.check(rc, f"dgrad_s2_phases DIAG={v}")

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
            key = f"{cin}→{cout} from {dhw[0]}³"
            record["ms"][f"{key}, {name}"] = ms
            print(f"{key} DIAG={v:2d} ({name}): {ms:.3f} ms", flush=True)
        del g, w, wtc, dx
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
