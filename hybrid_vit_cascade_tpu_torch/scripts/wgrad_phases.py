"""Where the tensor-core weight gradient spends its time, by ablation.

    python -m hybrid_vit_cascade_tpu_torch.scripts.wgrad_phases [--out FILE]

Builds copies of ``csrc/conv3d_k3_bwd.cu`` with phases of ``wgrad_tc_kernel``
switched off (the products, the register transpose of the staged patch, the
cp.async copies of x and of g; the flush of the accumulators stays) into
``build/wgrad_phases/``, one nvcc per variant in parallel, and times each at
the hot bf16 shapes: 64→32 stride 1 and 32→64 stride 2 at 256³, 66 splits
(one block per SM on an H100). A variant without a phase computes garbage:
the numbers say how long the rest takes, not what the kernel returns. Prints
one line per (shape, variant) with the median of 5 CUDA-event times, and a
JSON record with ``--out``. Needs nvcc and a CUDA card.
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

OUT_DIR = _build.BUILD_DIR.parent / "wgrad_phases"
# (text in the kernel, its replacement with the switch DIAG & bit)
SWITCHES = {
    1: ("    for (int vz = 0; vz < TD; ++vz) {",
        "    for (int vz = 0; vz < ((DIAG & 1) ? 0 : TD); ++vz) {"),
    2: ("    transpose();\n", "    if (!(DIAG & 2)) transpose();\n"),
    4: ("    if (tile + splits < n_tiles) issue(",
        "    if (!(DIAG & 4) && tile + splits < n_tiles) issue("),
    8: ("    for (int u = tid; u < kTcCi * NVEC * R; u += kTcThreads) {",
        "    for (int u = tid; u < ((DIAG & 8) ? 0 : kTcCi * NVEC * R); u += kTcThreads) {"),
    16: ("    for (int u = tid; u < kTcCo * TD * TH * (TW / 8); u += kTcThreads) {",
         "    for (int u = tid; u < ((DIAG & 16) ? 0 : kTcCo * TD * TH * (TW / 8)); "
         "u += kTcThreads) {"),
}
# DIAG value → what runs (the first tile's copies always run)
VARIANTS = {0: "all", 1: "no products", 2: "no transpose", 4: "no copies",
            6: "products only", 3: "copies only", 11: "copies of g only",
            19: "copies of x only"}
# stride → (x shape, g shape)
SHAPES = {1: ((1, 64, 256, 256, 256), (1, 32, 256, 256, 256)),
          2: ((1, 32, 256, 256, 256), (1, 64, 128, 128, 128))}
SPLITS = 66
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


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
        sys.exit("wgrad_phases: needs a CUDA card")
    libs = build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    record = {"card": torch.cuda.get_device_name(0), "splits": SPLITS, "ms": {}}
    for stride, (xs, gs) in SHAPES.items():
        x = torch.randn(xs, generator=gen, device=dev).bfloat16()
        g = torch.randn(gs, generator=gen, device=dev).bfloat16()
        part = torch.empty((SPLITS, gs[1], xs[1], 27), device=dev)
        out = torch.empty((gs[1], xs[1], 3, 3, 3), device=dev)
        for v, name in VARIANTS.items():
            fn = getattr(libs[v], f"hvc_conv3d_k3s{stride}_wgrad")
            fn.argtypes = [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _L, _L, _I, _I, _I, _P]
            fn.restype = _I
            stream = torch.cuda.current_stream(dev).cuda_stream

            def call():
                rc = fn(x.data_ptr(), g.data_ptr(), part.data_ptr(), out.data_ptr(), xs[0],
                        xs[1], gs[1], xs[2], xs[3], xs[4], gs[2], 1, x.stride(0), x.stride(1),
                        0, 1, SPLITS, stream)
                _build.check(rc, f"wgrad_phases DIAG={v}")

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
            record["ms"][f"stride {stride}, {name}"] = ms
            print(f"stride {stride} {xs[1]}→{gs[1]} DIAG={v:2d} ({name}): {ms:.3f} ms", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
