"""What reaching the forward kernels through the ``hvc::`` torch.library
operators costs, on one card.

    python -m hybrid_vit_cascade_tpu_torch.scripts.op_overhead [--out FILE]

Two measurements, each against the copy of the package it is run from (copy
this file into an older tree's ``scripts/`` to measure that tree the same
way; a tree without ``ops/cuda/library.py`` skips the first):

1. The host cost of one call: ``torch.ops.hvc.flash_attention_fwd`` against
   the bare wrapper ``flash_attention_fwd`` on (1, 64, 64, 32), and
   ``torch.ops.hvc.conv3d_k3`` against ``conv3d_k3`` on a dense 8→16 conv
   over 4 × 8 × 16, both bf16: shapes whose kernels take a few µs, so a call
   is bound by its host work. ``--calls`` calls a block, ``--reps`` blocks of
   each in turns, the host clock around a block ending in a sync; µs per
   call is a block's median over the calls.
2. The batch-1 reconstructs the operators sit under, as ``chip_smoke.py``
   times them ([6], [14]): the full-width cascade of
   ``configs/progressive_cascade.json`` (max_stage=3, stage 3 streamed) and
   ``direct_vit`` of ``configs/direct_64.json``, bf16 over weights seeded by
   ``seeded_init_`` (seed 0), one 512² X-ray pair; two warm-up calls, then
   ``--reps`` timed ones (host clock ending in a sync), median ms.

Prints the card's name and power limit, one line per measurement, and the
record as JSON (to ``--out`` as well). Needs the card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch

from ..config import Config
from ..inference.infer import InferenceEngine, build_model, save_checkpoint
from ..models.layers import seeded_init_
from ..ops.cuda import _build
from ..ops.cuda.conv3d_k3 import conv3d_k3
from ..ops.cuda.flash_attention import flash_attention_fwd

ROOT = Path(__file__).resolve().parents[2]
MODELS = {"cascade": ("progressive_cascade.json", {"max_stage": 3}),
          "direct_vit": ("direct_64.json", {})}


def _block_us(fn, calls: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def per_call_us(calls: int, reps: int) -> dict:
    """µs per call of each operator and its wrapper, blocks in turns."""
    import importlib.util

    if importlib.util.find_spec(f"{__package__.rsplit('.', 1)[0]}.ops.cuda.library") is None:
        return {}
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((1, 64, 32), device=dev, generator=g).to(torch.bfloat16)
    x = torch.randn((1, 8, 4, 8, 16), device=dev, generator=g).to(torch.bfloat16)
    w = torch.randn((16, 8, 3, 3, 3), device=dev, generator=g).to(torch.bfloat16)
    b = torch.zeros(16, device=dev)
    pairs = {"flash_attention_fwd": (lambda: flash_attention_fwd(q, q, q, 0.17),
                                     lambda: torch.ops.hvc.flash_attention_fwd(q, q, q, 0.17)),
             "conv3d_k3": (lambda: conv3d_k3(x, w, b, 1, 1, 4, dense=True),
                           lambda: torch.ops.hvc.conv3d_k3(x, w, b, 1, 1, 4, False, None, True))}
    out = {}
    for name, (wrapper, op) in pairs.items():
        times = {"wrapper": [], "op": []}
        _block_us(wrapper, calls), _block_us(op, calls)  # warm-up
        for i in range(reps):
            for which in (("wrapper", "op") if i % 2 == 0 else ("op", "wrapper")):
                times[which].append(_block_us(wrapper if which == "wrapper" else op, calls))
        med = {k: statistics.median(v) for k, v in times.items()}
        out[name] = {"wrapper_us": med["wrapper"], "op_us": med["op"],
                     "op_cost_us": med["op"] - med["wrapper"], "blocks_us": times}
        print(f"{name}: wrapper {med['wrapper']:.2f} µs a call, op {med['op']:.2f} µs "
              f"({med['op'] - med['wrapper']:+.2f}), median of {reps} blocks of {calls}",
              flush=True)
    return out


def reconstruct_ms(reps: int) -> dict:
    """Median batch-1 reconstruct of each model in MODELS."""
    dev = torch.device("cuda", 0)
    out = {}
    for name, (config, kw) in MODELS.items():
        cfg = Config.from_json(str(ROOT / "configs" / config))
        ckpt = _build.BUILD_DIR.parent / "op_overhead" / f"{name}.pt"
        ckpt.parent.mkdir(parents=True, exist_ok=True)
        save_checkpoint(ckpt, cfg, seeded_init_(build_model(cfg), 0))
        engine = InferenceEngine(ckpt, device=dev)
        size = cfg.data.xray_size
        xr = torch.rand((1, 2, 1, size, size), generator=torch.Generator().manual_seed(1))
        times = []
        for i in range(2 + reps):
            t0 = time.perf_counter()
            engine.reconstruct(xr, **kw)
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"median_ms": statistics.median(times), "ms": times}
        print(f"{name} reconstruct (batch 1, bf16): median {out[name]['median_ms']:.2f} ms over "
              f"{reps} ({', '.join(f'{t:.2f}' for t in times)})", flush=True)
        del engine
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=2000, help="calls a timed block")
    ap.add_argument("--reps", type=int, default=7, help="timed blocks and reconstructs")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("op_overhead: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    tree = str(Path(__file__).resolve().parents[2])
    print(f"card: {card}; tree {tree}; torch {torch.__version__}", flush=True)
    _build.library()
    rec = {"card": card, "tree": tree, "per_call": per_call_us(args.calls, args.reps),
           "reconstruct": reconstruct_ms(args.reps)}
    text = json.dumps(rec)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
