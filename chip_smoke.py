#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:

1. Require a CUDA device; print the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``).
2. Build the kernels from ``hybrid_vit_cascade_tpu_torch/csrc`` with nvcc
   (sm_90a) and print the build time.
3. Hold each kernel against its plain PyTorch version on the card, at every
   shape the main path gives it and at ragged small shapes, in bf16 and fp32.
4. The slice: the full-width progressive cascade of
   ``configs/progressive_cascade.json`` (bf16 compute over fp32 weights made
   from a seeded torch.Generator, written with torch.save and loaded back
   through InferenceEngine) reconstructs one 512² X-ray pair at
   max_stage=3 with return_intermediate=True. Checks the output shapes,
   finiteness, and that each kernel launched as often as the path needs it
   (36 flash attention, 5 stride-1 conv, 8 stride-2 conv).
5. A small-input reference: a scaled cascade in fp32 on the card (kernels)
   against the same weights on the CPU (plain versions).
6. Timings from CUDA events and the host clock after a warm-up: the median
   end-to-end reconstruct time and volumes/s, and each kernel beside its
   plain version at the main-path shapes.

cuDNN and cuBLAS run with TF32 off (torch.backends.cudnn.allow_tf32 and
torch.backends.cuda.matmul.allow_tf32 are set False), so the fp32 plain
versions are full fp32. The second-to-last line of the output is a
{"kernels": [...]} JSON object, the last line {"ok": true, "device": ...};
the full record goes to build/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "progressive_cascade.json"
BUILD_DIR = ROOT / "build"
CKPT_DIR = BUILD_DIR / "smoke"

# |got - want| <= atol + rtol·|want|. fp32: both sides accumulate in fp32, in
# another order. bf16: both sides compute in fp32 from the same bf16 inputs
# and round once to bf16 (one ulp is 2^-8 relative).
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
# The small-input reference: fp32 end to end, tolerance of
# tests/test_parity_cascade.py:345.
SMALL_TOL = (2e-4, 2e-4)

# Per max_stage=3 forward at the default widths: flash attention in the self-
# and cross-attention of 4 + 6 + 8 blocks; stride-1 conv = stage-1 projection
# (128→256 at 16³), stage-2 upsample conv, stage-3 upsample conv and the two
# detail convs; stride-2 conv = 2 + 3 + 3 token-stem convs.
EXPECTED_LAUNCHES = {"flash_attention": 36, "conv3d_k3s1": 5, "conv3d_k3s2": 8}
REPS = 5  # timed reconstruct calls

KERNELS = {
    "flash_attention": {
        "source": "hybrid_vit_cascade_tpu_torch/csrc/flash_attention.cu",
        "replaces": "hybrid_vit_cascade_tpu/ops/pallas/flash_attention.py:156",
        # (BH, Nq, Nk, d): stage 1 self/cross, stage 2 self/cross, stage 3 self/cross
        "shapes": [(4, 4096, 4096, 64), (4, 4096, 256, 64), (8, 4096, 4096, 32),
                   (8, 4096, 1024, 32), (8, 32768, 32768, 32), (8, 32768, 4096, 32)],
        "ragged": [(3, 200, 77, 32), (3, 200, 77, 64)],
        "hot": (8, 32768, 32768, 32),
    },
    "conv3d_k3s1": {
        "source": "hybrid_vit_cascade_tpu_torch/csrc/conv3d_k3.cu",
        "replaces": "hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3.py:439",
        # (B, Cin, Cout, (D, H, W))
        "shapes": [(1, 128, 256, (16, 16, 16)), (1, 1, 32, (128, 128, 128)),
                   (1, 1, 32, (256, 256, 256)), (1, 1, 64, (256, 256, 256)),
                   (1, 64, 32, (256, 256, 256))],
        "ragged": [(2, 3, 5, (5, 6, 10)), (1, 8, 40, (5, 6, 10))],
        "hot": (1, 64, 32, (256, 256, 256)),
    },
    "conv3d_k3s2": {
        "source": "hybrid_vit_cascade_tpu_torch/csrc/conv3d_k3.cu",
        "replaces": "hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3s2.py:225",
        "shapes": [(1, 1, 64, (64, 64, 64)), (1, 64, 128, (32, 32, 32)),
                   (1, 32, 64, (128, 128, 128)), (1, 64, 128, (64, 64, 64)),
                   (1, 128, 256, (32, 32, 32)), (1, 32, 64, (256, 256, 256)),
                   (1, 64, 128, (128, 128, 128)), (1, 128, 256, (64, 64, 64))],
        "ragged": [(2, 3, 5, (5, 6, 10)), (1, 8, 40, (5, 6, 10))],
        "hot": (1, 32, 64, (256, 256, 256)),
    },
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- kernels ---

def _inputs(name: str, shape, dtype, dev, seed: int):
    g = torch.Generator(device=dev).manual_seed(seed)
    if name == "flash_attention":
        bh, nq, nk, d = shape
        q = torch.randn((bh, nq, d), generator=g, device=dev).to(dtype)
        k = torch.randn((bh, nk, d), generator=g, device=dev).to(dtype)
        v = torch.randn((bh, nk, d), generator=g, device=dev).to(dtype)
        return (q, k, v, d ** -0.5)
    b, cin, cout, dhw = shape
    x = torch.randn((b, cin, *dhw), generator=g, device=dev).to(dtype)
    w = (torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) / (27 * cin) ** 0.5).to(dtype)
    bias = 0.1 * torch.randn((cout,), generator=g, device=dev)
    return (x, w, bias)


def _fns(name: str):
    from hybrid_vit_cascade_tpu_torch.ops.cuda import conv3d_k3 as ck
    from hybrid_vit_cascade_tpu_torch.ops.cuda import flash_attention as fa

    if name == "flash_attention":
        return fa.flash_attention_fwd, fa.flash_attention_plain
    stride = 1 if name == "conv3d_k3s1" else 2
    kern = ck.conv3d_k3s1 if stride == 1 else ck.conv3d_k3s2
    return (kern, lambda x, w, b: ck.conv3d_k3_plain(x, w, b, stride))


def check_kernels(dev, seed: int) -> dict:
    """Phase 3: every kernel against its plain version; returns the max error
    per kernel."""
    worst = {}
    for name, spec in KERNELS.items():
        kern, plain = _fns(name)
        worst[name] = 0.0
        for shape in spec["shapes"] + spec["ragged"]:
            for dtype in (torch.bfloat16, torch.float32):
                args = _inputs(name, shape, dtype, dev, seed)
                got, want = kern(*args), plain(*args)
                if name == "flash_attention":  # (out, lse): check both
                    pairs = [("out", got[0], want[0], dtype),
                             ("lse", got[1], want[1], torch.float32)]
                else:
                    pairs = [("out", got, want, dtype)]
                torch.cuda.synchronize()
                for label, g, w, dt in pairs:
                    if g.shape != w.shape or g.dtype != w.dtype:
                        raise AssertionError(f"{name} {shape}: {g.shape}/{g.dtype} vs "
                                             f"{w.shape}/{w.dtype}")
                    atol, rtol = TOL[dt]
                    diff = (g.float() - w.float()).abs()
                    err = float(diff.max())
                    ok = bool(torch.isfinite(g.float()).all()) and bool(
                        (diff <= atol + rtol * w.float().abs()).all())
                    log(f"  {name:16s} {str(shape):32s} {str(dtype):15s} {label} "
                        f"max_abs_err={err:.3e} tol={atol:g}+{rtol:g}|ref| {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"{name} disagrees with its plain version at "
                                             f"{shape} {dtype}: max_abs_err {err}")
                    worst[name] = max(worst[name], err)
                del args, got, want, pairs
    return worst


def time_kernels(dev, seed: int) -> dict:
    """Phase 6b: each kernel beside its plain version at every main-path
    shape, bf16 (the main path's dtype), in turns plain, kernel, kernel,
    plain; median of the per-launch CUDA-event times."""

    def once(fn, args) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    rows = {}
    for name, spec in KERNELS.items():
        kern, plain = _fns(name)
        for shape in spec["shapes"]:
            args = _inputs(name, shape, torch.bfloat16, dev, seed)
            kern(*args), plain(*args)  # warm-up
            t_k, t_p = [], []
            for _ in range(3):
                t_p.append(once(plain, args))
                t_k.append(once(kern, args))
                t_k.append(once(kern, args))
                t_p.append(once(plain, args))
            ms, plain_ms = statistics.median(t_k), statistics.median(t_p)
            rows[(name, shape)] = (ms, plain_ms)
            log(f"  {name:16s} {str(shape):32s} bf16 kernel {ms:9.3f} ms   plain {plain_ms:9.3f} ms")
            del args
    return rows


# ------------------------------------------------------------------ slice ---

def reset_launches() -> None:
    from hybrid_vit_cascade_tpu_torch.ops.cuda import conv3d_k3 as ck
    from hybrid_vit_cascade_tpu_torch.ops.cuda import flash_attention as fa

    fa.flash_attention_fwd.launches = 0
    ck.conv3d_k3s1.launches = 0
    ck.conv3d_k3s2.launches = 0


def read_launches() -> dict:
    from hybrid_vit_cascade_tpu_torch.ops.cuda import conv3d_k3 as ck
    from hybrid_vit_cascade_tpu_torch.ops.cuda import flash_attention as fa

    return {"flash_attention": fa.flash_attention_fwd.launches,
            "conv3d_k3s1": ck.conv3d_k3s1.launches, "conv3d_k3s2": ck.conv3d_k3s2.launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of weights and inputs")
    args = ap.parse_args()

    # 1. the card
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False); "
                 "the port's kernels run only on the card")
    from hybrid_vit_cascade_tpu.config import Config
    from hybrid_vit_cascade_tpu_torch.inference.infer import (
        InferenceEngine,
        build_model,
        save_checkpoint,
    )
    from hybrid_vit_cascade_tpu_torch.models.layers import seeded_init_
    from hybrid_vit_cascade_tpu_torch.ops.cuda import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"TF32 off for cuDNN and cuBLAS")
    record = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    log(f"[2] built {lib_path.relative_to(ROOT)} in {build_s:.1f} s")
    ptxas = [line.strip() for line in (lib_path.parent / "nvcc.log").read_text().splitlines()
             if "registers" in line or "spill" in line]
    record.update(build_s=build_s, ptxas=ptxas)

    # 3. kernels against their plain versions
    log("[3] kernels vs plain versions (bf16 and fp32)")
    worst = check_kernels(dev, args.seed)
    record["max_abs_err"] = worst

    # 4. the slice
    cfg = Config.from_json(str(CONFIG))
    m = cfg.model
    widths = (m.family, m.voxel_dim, m.xray_feature_dim, m.dtype, tuple(m.stage_depths),
              tuple(m.stage_heads), tuple(m.stage_sizes), cfg.data.xray_size)
    if widths != ("cascade", 256, 512, "bfloat16", (4, 6, 8), (4, 8, 8), (64, 128, 256), 512):
        raise AssertionError(f"{CONFIG.name} no longer holds the default cascade: {widths}")
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    ckpt = CKPT_DIR / "cascade_seeded.pt"
    t0 = time.perf_counter()
    model = seeded_init_(build_model(cfg), args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    save_checkpoint(ckpt, cfg, model)
    del model
    engine = InferenceEngine(ckpt, device=dev, max_stage=3)
    load_s = time.perf_counter() - t0
    xr = torch.rand((1, 2, 1, cfg.data.xray_size, cfg.data.xray_size),
                    generator=torch.Generator().manual_seed(args.seed + 1))
    log(f"[4] slice: {n_params / 1e6:.1f} M parameters, seeded, saved and loaded in "
        f"{load_s:.1f} s")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    out = engine.reconstruct(xr, max_stage=3, return_intermediate=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    for stage, size in (("stage1", 64), ("stage2", 128), ("stage3", 256)):
        v = out[stage]
        finite = bool(torch.isfinite(v.float()).all())
        log(f"    {stage}: shape {tuple(v.shape)} {v.dtype} finite={finite} "
            f"mean={float(v.float().mean()):.4f} std={float(v.float().std()):.4f}")
        if tuple(v.shape) != (1, 1, size, size, size) or not finite:
            raise AssertionError(f"{stage}: expected finite (1, 1, {size}³), got {tuple(v.shape)}")
    log(f"    launches {launches} (expected {EXPECTED_LAUNCHES}); first call {first_s:.2f} s; "
        f"peak memory {peak_gb:.2f} GB")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"launch counts {launches} != {EXPECTED_LAUNCHES}")
    record.update(n_params=n_params, launches=launches, first_call_s=first_s,
                  peak_memory_gb=peak_gb)
    del out

    # 5. small-input reference: card (kernels) vs CPU (plain versions), fp32
    small = Config.from_dict(cfg.to_dict())
    sm = small.model
    sm.voxel_dim, sm.xray_feature_dim, sm.dtype = 128, 128, "float32"
    sm.stage_depths, sm.stage_heads, sm.stage_sizes = (1, 1, 1), (4, 4, 4), (8, 16, 32)
    cpu_model = seeded_init_(build_model(small), args.seed).eval()
    gpu_model = seeded_init_(build_model(small), args.seed).to(dev).eval()
    xs = torch.rand((1, 2, 1, 64, 64), generator=torch.Generator().manual_seed(args.seed + 2))
    before = read_launches()
    with torch.inference_mode():
        want = cpu_model(xs, return_intermediate=True)
        got = gpu_model(xs.to(dev), return_intermediate=True)
    after = read_launches()
    small_err = {}
    atol, rtol = SMALL_TOL
    for stage in ("stage1", "stage2", "stage3"):
        g, w = got[stage].cpu(), want[stage]
        diff = (g - w).abs()
        small_err[stage] = float(diff.max())
        ok = bool((diff <= atol + rtol * w.abs()).all())
        log(f"[5] small reference {stage} {tuple(g.shape)}: max_abs_err={small_err[stage]:.3e} "
            f"tol={atol:g}+{rtol:g}|ref| {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"small-input reference disagrees at {stage}")
    if any(after[k] <= before[k] for k in after):
        raise AssertionError(f"small reference did not run every kernel: {before} → {after}")
    record["small_reference_max_abs_err"] = small_err
    del cpu_model, gpu_model, got, want

    # 6. timings
    engine.reconstruct(xr, max_stage=3)  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        engine.reconstruct(xr, max_stage=3)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(f"[6] reconstruct 256³ (batch 1, bf16, max_stage=3): median {med * 1e3:.1f} ms over "
        f"{REPS} calls ({', '.join(f'{t * 1e3:.1f}' for t in times)}); "
        f"{1.0 / med:.3f} volumes/s")
    record.update(reconstruct_ms=[t * 1e3 for t in times], reconstruct_median_ms=med * 1e3,
                  volumes_per_s=1.0 / med)
    del engine
    torch.cuda.empty_cache()
    rows = time_kernels(dev, args.seed)
    record["kernel_ms"] = {f"{n} {s}": {"ms": a, "plain_ms": b} for (n, s), (a, b) in rows.items()}
    record["after_timing"] = nvidia_smi("clocks.sm,power.draw,temperature.gpu")

    kernels = []
    for name, spec in KERNELS.items():
        ms, plain_ms = rows[(name, spec["hot"])]
        kernels.append({"name": name, "route": "cuda", "source": spec["source"],
                        "replaces": spec["replaces"], "launches": launches[name],
                        "max_abs_err": worst[name], "ms": ms, "plain_ms": plain_ms,
                        "at": f"{spec['hot']} bf16"})
    (BUILD_DIR / "chip_smoke.json").write_text(json.dumps({**record, "kernels": kernels}, indent=1))
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
