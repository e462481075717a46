"""Where the tensor-core flash backward (kernel D) spends its time, by
ablation, and which grid the tensor-core dk/dv kernel (M) runs faster on.

    python -m hybrid_vit_cascade_tpu_torch.scripts.flash_bwd_phases [--out FILE]

Builds ``csrc/flash_attention_bwd.cu`` and ``csrc/flash_attention_bwd_split.cu``
against copies of ``csrc/flash_bwd_tc.cuh`` with phases of
``flash_bwd_tc_kernel`` switched off (D: the ordered wait on the previous
key tile, the reads and writes of the dq accumulator, the dq product, the
exp2s) or M's grid changed (DIAG 16: a persistent grid, the blocks the
occupancy calculator allows on every SM, each taking every grid-th item,
in place of one block per item) into ``build/flash_bwd_phases/``, one nvcc
per variant in parallel, and times each at the main path's bf16 shapes: the
stage-3 self-attention (8 × 32,768² × 32) and cross-attention (8 × 32,768 ×
4,096 × 32). A variant without a phase computes garbage: the numbers say
how long the rest takes, not what the kernel returns; M's two grids must
give the same bits. Prints one line per (shape, variant) with the median
of 5 CUDA-event times, and a JSON record with ``--out``. Needs nvcc and a
CUDA card.
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
    16: ("  if (DQ) {  // D: the blocks the occupancy calculator allows on every SM",
         "  if (DQ || (DIAG & 16)) {  // D: the blocks the occupancy calculator allows on every SM"),
}
HEADER = "flash_bwd_tc.cuh"
SOURCES = ("flash_attention_bwd.cu", "flash_attention_bwd_split.cu")
# (DIAG value, kernel, what runs): D's phases, then M's grids
VARIANTS = [(0, "D", "all"), (1, "D", "no wait"), (3, "D", "no wait, no dq add"),
            (7, "D", "no wait, dq add, dq product"), (8, "D", "no exp2"),
            (15, "D", "S, dP, P, dS, dV, dK only"), (0, "M", "one block per item"),
            (16, "M", "persistent grid")]
SHAPES = [(8, 32768, 32768, 32), (8, 32768, 4096, 32)]


def ablated_source() -> str:
    """The shared kernel header with each switch behind a bit of the DIAG
    macro."""
    src = (_build.CSRC_DIR / HEADER).read_text()
    for bit, (old, new) in SWITCHES.items():
        if src.count(old) != 1:
            raise RuntimeError(f"phase switch {bit} does not match the kernel: {old!r}")
        src = src.replace(old, new)
    return src


def build() -> dict:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for f in (*_build.headers(), *(_build.CSRC_DIR / n for n in SOURCES)):
        (OUT_DIR / f.name).write_text(f.read_text())
    (OUT_DIR / HEADER).write_text(ablated_source())
    nvcc = _build.find_nvcc()
    procs = {v: subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-shared", f"-DDIAG={v}", "-o",
                                  str(OUT_DIR / f"k{v}.so"), *(str(OUT_DIR / n) for n in SOURCES)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for v in sorted({v for v, _, _ in VARIANTS})}
    libs = {}
    for v, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for DIAG={v}:\n{out}")
        libs[v] = ctypes.CDLL(str(OUT_DIR / f"k{v}.so"))
    return libs


def _entry(lib, name: str, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _median_ms(call, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event times of ``call`` after one warm-up."""
    call()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
        stream = torch.cuda.current_stream(dev).cuda_stream
        m_out = {}
        for var, kern, name in VARIANTS:
            if kern == "M":
                fn = _entry(libs[var], "hvc_flash_attention_bwd_dkv", fa._DKV_ARGTYPES)

                def call():
                    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh,
                            nq, nk, d, 1, d ** -0.5, stream)
                    _build.check(rc, f"flash_bwd_phases M DIAG={var}")
            else:
                fn = _entry(libs[var], "hvc_flash_attention_bwd", fa._FUSED_ARGTYPES)

                def call():
                    counters.zero_()
                    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                            lse.data_ptr(), delta.data_ptr(), acc.data_ptr(), counters.data_ptr(),
                            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, nq, nk, d, 1, 1,
                            d ** -0.5, stream)
                    _build.check(rc, f"flash_bwd_phases DIAG={var}")

            ms = _median_ms(call)
            if kern == "M":
                m_out[var] = (dk.clone(), dv.clone())
            record["ms"][f"{(bh, nq, nk, d)}, {kern}: {name}"] = ms
            print(f"{(bh, nq, nk, d)} {kern} DIAG={var:2d} ({name}): {ms:.3f} ms", flush=True)
        if not all(torch.equal(x, y) for x, y in zip(*m_out.values())):
            raise AssertionError(f"M's two grids disagree at {(bh, nq, nk, d)}")
        del q, k, v, dout, out, lse, delta, acc, dq, dk, dv
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
