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
7. The gradient kernels — D (flash backward), E (stride-1 weight gradient),
   F (stride-2 data gradient), G (stride-2 weight gradient) and kernel B run
   as the stride-1 data gradient — against their plain versions at every
   shape the three training stages give them (and ragged small shapes), in
   bf16 and fp32, with kernel and plain times at the training shapes.
8. A small training reference: one scaled stage-3 train step (deterministic
   forward, fp32) on the card (kernels) against the same step on the CPU
   (plain versions): loss and every trainable gradient within 2e-4.
9. The training slice: the full-width cascade trains stage 1 (64³, batch 8),
   stage 2 (128³, batch 2) and stage 3 (256³, batch 1) the way the JAX
   trainer's fit_cascade builds each stage (trainable stage + shared encoder,
   AdamW with the stage's learning rate, MultiScaleLoss at the stage's
   resolution, stop_grad_stage1, remat 'mlp' at stage 3), on seeded X-rays
   and a seeded 256³ CT volume: one warm-up step and 3 timed ones per stage,
   finite losses, peak memory, and each kernel's launches per step (every
   counted wrapper, B as the stride-1 data gradient included, launches in
   the stage-3 step).

cuDNN and cuBLAS run with TF32 off (torch.backends.cudnn.allow_tf32 and
torch.backends.cuda.matmul.allow_tf32 are set False), so the fp32 plain
versions are full fp32. The second-to-last line of the output is a
{"kernels": [...]} JSON object, the last line {"ok": true, "device": ...};
the full record goes to build/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import math
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
# Gradient kernels take the same bounds with the absolute part scaled by the
# largest |want| of the call: their sums run over up to 16.7 M voxels or
# 32,768 keys, so an element that cancels to near zero carries the rounding
# of terms at the full scale.
# The small-input references: fp32 end to end, tolerance of
# tests/test_parity_cascade.py:345.
SMALL_TOL = (2e-4, 2e-4)

# Per max_stage=3 forward at the default widths: flash attention in the self-
# and cross-attention of 4 + 6 + 8 blocks; stride-1 conv = stage-1 projection
# (128→256 at 16³), stage-2 upsample conv, stage-3 upsample conv and the two
# detail convs; stride-2 conv = 2 + 3 + 3 token-stem convs.
EXPECTED_LAUNCHES = {"flash_attention": 36, "conv3d_k3s1": 5, "conv3d_k3s2": 8}
REPS = 5  # timed reconstruct calls
TRAIN_STEPS = 3  # timed train steps per stage, after one warm-up step
TRAIN_BATCH = {1: 8, 2: 2, 3: 1}

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

# Gradient kernels at the shapes of the training slice ([9]): stage 1 at
# batch 8, stage 2 at batch 2, stage 3 at batch 1.
_S2_GRAD_SHAPES = [(8, 1, 64, (64, 64, 64)), (8, 64, 128, (32, 32, 32)),
                   (2, 32, 64, (128, 128, 128)), (2, 64, 128, (64, 64, 64)),
                   (2, 128, 256, (32, 32, 32)), (1, 32, 64, (256, 256, 256)),
                   (1, 64, 128, (128, 128, 128)), (1, 128, 256, (64, 64, 64))]
_RAGGED_CONV = [(2, 3, 5, (5, 6, 10)), (1, 8, 40, (5, 6, 10))]
TRAIN_KERNELS = {
    "flash_attention_bwd": {
        "source": "hybrid_vit_cascade_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "hybrid_vit_cascade_tpu/ops/pallas/flash_attention.py:399",
        # (BH, Nq, Nk, d): stage 1 self/cross, stage 2 self/cross, stage 3 self/cross
        "shapes": [(32, 4096, 4096, 64), (32, 4096, 256, 64), (16, 4096, 4096, 32),
                   (16, 4096, 1024, 32), (8, 32768, 32768, 32), (8, 32768, 4096, 32)],
        "ragged": [(3, 200, 77, 32), (3, 200, 77, 64)],
        "hot": (8, 32768, 32768, 32),
    },
    "conv3d_k3s1_wgrad": {
        "source": "hybrid_vit_cascade_tpu_torch/csrc/conv3d_k3_bwd.cu",
        "replaces": "hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3.py:592",
        # (B, Cin, Cout, (D, H, W)) of the forward conv
        "shapes": [(8, 128, 256, (16, 16, 16)), (2, 1, 32, (128, 128, 128)),
                   (1, 1, 32, (256, 256, 256)), (1, 1, 64, (256, 256, 256)),
                   (1, 64, 32, (256, 256, 256))],
        "ragged": _RAGGED_CONV,
        "hot": (1, 64, 32, (256, 256, 256)),
    },
    "conv3d_k3s1_dgrad": {  # kernel B with flipped weights, counted on its own
        "source": "hybrid_vit_cascade_tpu_torch/csrc/conv3d_k3.cu",
        "replaces": "hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3.py:439",
        "shapes": [(8, 128, 256, (16, 16, 16)), (1, 1, 32, (256, 256, 256)),
                   (1, 1, 64, (256, 256, 256)), (1, 64, 32, (256, 256, 256))],
        "ragged": _RAGGED_CONV,
        "hot": (1, 64, 32, (256, 256, 256)),
    },
    "conv3d_k3s2_dgrad": {
        "source": "hybrid_vit_cascade_tpu_torch/csrc/conv3d_k3_bwd.cu",
        "replaces": "hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3s2.py:396",
        "shapes": _S2_GRAD_SHAPES,
        "ragged": _RAGGED_CONV,
        "hot": (1, 32, 64, (256, 256, 256)),
    },
    "conv3d_k3s2_wgrad": {
        "source": "hybrid_vit_cascade_tpu_torch/csrc/conv3d_k3_bwd.cu",
        "replaces": "hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3s2.py:535",
        "shapes": _S2_GRAD_SHAPES,
        "ragged": _RAGGED_CONV,
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


def check_kernels(dev, seed: int, specs: dict, inputs, fns, scaled: bool = False) -> dict:
    """Phases 3 and 7: every kernel of ``specs`` against its plain version at
    every shape, in bf16 and fp32; returns the max error per kernel. Each
    output is held to the tolerance of its own dtype (flash attention's lse
    and the weight gradients are fp32); ``scaled`` multiplies the absolute
    part by the largest |want| of the call."""
    worst = {}
    for name, spec in specs.items():
        kern, plain = fns(name)
        worst[name] = 0.0
        for shape in spec["shapes"] + spec["ragged"]:
            for dtype in (torch.bfloat16, torch.float32):
                args = inputs(name, shape, dtype, dev, seed)
                got, want = kern(*args), plain(*args)
                if not isinstance(got, tuple):
                    got, want = (got,), (want,)
                torch.cuda.synchronize()
                for i, (g, w) in enumerate(zip(got, want)):
                    if g.shape != w.shape or g.dtype != w.dtype:
                        raise AssertionError(f"{name} {shape}: {g.shape}/{g.dtype} vs "
                                             f"{w.shape}/{w.dtype}")
                    atol, rtol = TOL[w.dtype]
                    diff = (g.float() - w.float()).abs()
                    err = float(diff.max())
                    scale = max(1.0, float(w.float().abs().max())) if scaled else 1.0
                    ok = bool(torch.isfinite(g.float()).all()) and bool(
                        (diff <= atol * scale + rtol * w.float().abs()).all())
                    log(f"  {name:19s} {str(shape):32s} {str(dtype):15s} out{i} "
                        f"max_abs_err={err:.3e} tol={atol:g}·{scale:.3g}+{rtol:g}|ref| "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"{name} disagrees with its plain version at "
                                             f"{shape} {dtype}: max_abs_err {err}")
                    worst[name] = max(worst[name], err)
                del args, got, want
    return worst


def _once(fn, args) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _time_pair(kern, plain, args) -> tuple[float, float]:
    """Medians of the CUDA-event times of kernel and plain version, in turns
    plain, kernel, kernel, plain, after a warm-up of each."""
    kern(*args), plain(*args)
    t_k, t_p = [], []
    for _ in range(3):
        t_p.append(_once(plain, args))
        t_k.append(_once(kern, args))
        t_k.append(_once(kern, args))
        t_p.append(_once(plain, args))
    return statistics.median(t_k), statistics.median(t_p)


def time_kernels(dev, seed: int, specs: dict, inputs, fns) -> dict:
    """Phases 6b and 7b: each kernel beside its plain version at every shape
    of its spec, bf16 (the main path's dtype)."""
    rows = {}
    for name, spec in specs.items():
        kern, plain = fns(name)
        for shape in spec["shapes"]:
            args = inputs(name, shape, torch.bfloat16, dev, seed)
            ms, plain_ms = _time_pair(kern, plain, args)
            rows[(name, shape)] = (ms, plain_ms)
            log(f"  {name:19s} {str(shape):32s} bf16 kernel {ms:9.3f} ms   plain {plain_ms:9.3f} ms")
            del args
    return rows


# -------------------------------------------------------- gradient kernels ---

def _train_inputs(name: str, shape, dtype, dev, seed: int):
    """Arguments of a gradient kernel and of its plain version."""
    from hybrid_vit_cascade_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(seed)
    if name == "flash_attention_bwd":
        bh, nq, nk, d = shape
        q, dout = (torch.randn((bh, nq, d), generator=g, device=dev).to(dtype) for _ in range(2))
        k, v = (torch.randn((bh, nk, d), generator=g, device=dev).to(dtype) for _ in range(2))
        out, lse = fa.flash_attention_plain(q, k, v, d ** -0.5)
        return (q, k, v, out, lse, dout, d ** -0.5)
    b, cin, cout, dhw = shape
    stride = 2 if "s2" in name else 1
    odhw = tuple((n - 1) // stride + 1 for n in dhw)
    gy = torch.randn((b, cout, *odhw), generator=g, device=dev).to(dtype)
    if name.endswith("wgrad"):
        return (torch.randn((b, cin, *dhw), generator=g, device=dev).to(dtype), gy)
    w = (torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) / (27 * cin) ** 0.5).to(dtype)
    return (gy, w) if stride == 1 else (gy, w, (b, cin, *dhw))


def _train_fns(name: str):
    from hybrid_vit_cascade_tpu_torch.ops.cuda import conv3d_k3 as ck
    from hybrid_vit_cascade_tpu_torch.ops.cuda import flash_attention as fa

    if name == "flash_attention_bwd":
        return fa.flash_attention_bwd, fa.flash_attention_bwd_plain
    if name == "conv3d_k3s1_dgrad":
        return ck.conv3d_k3s1_dgrad, lambda g, w: ck.conv3d_k3_dgrad_plain(
            g, w, (g.shape[0], w.shape[1], *g.shape[2:]), 1)
    if name == "conv3d_k3s2_dgrad":
        return ck.conv3d_k3s2_dgrad, lambda g, w, shape: ck.conv3d_k3_dgrad_plain(g, w, shape, 2)
    stride = 1 if name == "conv3d_k3s1_wgrad" else 2
    kern = ck.conv3d_k3s1_wgrad if stride == 1 else ck.conv3d_k3s2_wgrad
    return kern, lambda x, g: ck.conv3d_k3_wgrad_plain(x, g, stride)


# -------------------------------------------------------------- training ---

def scaled_config(cfg):
    """The small-input configuration of [5] and [8]: widths cut so every
    kernel still runs (d = 32 heads, one stride-2 stem conv at stage 3)."""
    from hybrid_vit_cascade_tpu_torch.config import Config

    small = Config.from_dict(cfg.to_dict())
    sm = small.model
    sm.voxel_dim, sm.xray_feature_dim, sm.dtype = 128, 128, "float32"
    sm.stage_depths, sm.stage_heads, sm.stage_sizes = (1, 1, 1), (4, 4, 4), (8, 16, 32)
    for n, size in zip((1, 2, 3), (8, 16, 32)):
        small.training.stages[f"stage{n}"].target_resolution = (size, size, size)
    small.data.xray_size = 64
    return small


def train_reference(cfg, dev, seed: int) -> dict:
    """Phase 8: one scaled stage-3 train step, card against CPU."""
    from hybrid_vit_cascade_tpu_torch.inference.infer import build_model
    from hybrid_vit_cascade_tpu_torch.losses.multiscale import MultiScaleLoss
    from hybrid_vit_cascade_tpu_torch.models.layers import seeded_init_
    from hybrid_vit_cascade_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from hybrid_vit_cascade_tpu_torch.training.trainer import stage_step

    small = scaled_config(cfg)
    g = torch.Generator().manual_seed(seed + 3)
    batch = {"drr_stacked": torch.rand((1, 2, 1, 64, 64), generator=g) * 2 - 1,
             "ct_volume": torch.rand((1, 1, 32, 32, 32), generator=g) * 2 - 1}
    runs = {}
    for where in ("cpu", dev):
        model = seeded_init_(build_model(small), seed).to(where)
        state, step = stage_step(model, small, 3, MultiScaleLoss(), train=False)
        b = {k: v.to(where) for k, v in batch.items()}
        reset_launch_counts()
        _, metrics = step(state, b, None)
        runs[str(where)] = (metrics, {n: p.grad.cpu() for n, p in model.named_parameters()
                                      if p.grad is not None}, launch_counts())
    (m_cpu, g_cpu, _), (m_gpu, g_gpu, launched) = runs["cpu"], runs[str(dev)]
    atol, rtol = SMALL_TOL
    worst = {"loss": 0.0, "grad": 0.0}
    for k in m_cpu:
        err = abs(float(m_gpu[k]) - float(m_cpu[k]))
        worst["loss"] = max(worst["loss"], err)
        if err > atol + rtol * abs(float(m_cpu[k])):
            raise AssertionError(f"[8] {k}: card {float(m_gpu[k])} vs cpu {float(m_cpu[k])}")
    if sorted(g_cpu) != sorted(g_gpu) or not g_cpu:
        raise AssertionError("[8] the card and the CPU step trained different parameters")
    for n, w in g_cpu.items():
        diff = (g_gpu[n] - w).abs()
        worst["grad"] = max(worst["grad"], float(diff.max()))
        if not bool((diff <= atol + rtol * w.abs()).all()):
            raise AssertionError(f"[8] gradient of {n} disagrees: max_abs_err {float(diff.max())}")
    log(f"[8] small train reference (stage 3, fp32, {len(g_cpu)} trainable tensors): "
        f"total_loss card {float(m_gpu['total_loss']):.6f} cpu {float(m_cpu['total_loss']):.6f}; "
        f"max_abs_err loss {worst['loss']:.3e} grads {worst['grad']:.3e} "
        f"tol={atol:g}+{rtol:g}|ref| ok; launches {launched}")
    if 0 in launched.values():
        raise AssertionError(f"[8] the card's step did not run every kernel: {launched}")
    return {"max_abs_err": worst, "launches": launched}


def train_full_width(cfg, dev, seed: int) -> dict:
    """Phase 9: full-width training of stages 1, 2 and 3."""
    from hybrid_vit_cascade_tpu_torch.inference.infer import build_model
    from hybrid_vit_cascade_tpu_torch.losses.multiscale import MultiScaleLoss
    from hybrid_vit_cascade_tpu_torch.models.layers import seeded_init_
    from hybrid_vit_cascade_tpu_torch.training.measure import train_steps

    model = seeded_init_(build_model(cfg), seed).to(dev)
    loss_obj = MultiScaleLoss({f"stage{n}": getattr(cfg.loss, f"stage{n}") for n in (1, 2, 3)})
    out = {}
    for stage in (1, 2, 3):
        b = TRAIN_BATCH[stage]
        g = torch.Generator(device=dev).manual_seed(seed + 10 + stage)
        r = train_steps(model, cfg, stage, b, TRAIN_STEPS, g, loss_obj=loss_obj)
        res = (64, 128, 256)[stage - 1]
        key = f"train_stage{stage}_{res}_b{b}_steps_per_sec"
        r[key] = r.pop("steps_per_sec")
        log(f"[9] stage {stage} ({res}³, batch {b}, {r['trainable_params'] / 1e6:.1f} M "
            f"trainable): {key} = {r[key]:.4f} (steps "
            f"{', '.join(f'{t:.1f}' for t in r['step_ms'])} ms; warm-up {r['warmup_s']:.2f} s); "
            f"peak memory {r['peak_allocated_gb']:.2f} GB; total_loss per step "
            f"{', '.join(f'{v:.5f}' for v in r['total_loss'])}; launches per step "
            f"{r['launches_per_step']}")
        if not all(math.isfinite(v) for v in r["total_loss"]):
            raise AssertionError(f"[9] stage {stage}: non-finite loss {r['total_loss']}")
        out[f"stage{stage}"] = r
        torch.cuda.empty_cache()
    if 0 in out["stage3"]["launches_per_step"].values():
        raise AssertionError(f"[9] the stage-3 step did not run every kernel: "
                             f"{out['stage3']['launches_per_step']}")
    return out


# ------------------------------------------------------------------ slice ---

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of weights and inputs")
    args = ap.parse_args()

    # 1. the card
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False); "
                 "the port's kernels run only on the card")
    from hybrid_vit_cascade_tpu_torch.config import Config
    from hybrid_vit_cascade_tpu_torch.inference.infer import (
        InferenceEngine,
        build_model,
        save_checkpoint,
    )
    from hybrid_vit_cascade_tpu_torch.models.layers import seeded_init_
    from hybrid_vit_cascade_tpu_torch.ops.cuda import _build, launch_counts, reset_launch_counts

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
    worst = check_kernels(dev, args.seed, KERNELS, _inputs, _fns)
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
    reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.reconstruct(xr, max_stage=3, return_intermediate=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launched = launch_counts()
    launches = {k: launched[k] for k in EXPECTED_LAUNCHES}
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
    if launches != EXPECTED_LAUNCHES or any(launched[k] for k in launched if k not in launches):
        raise AssertionError(f"launch counts {launched}: expected {EXPECTED_LAUNCHES} and "
                             f"no gradient kernel")
    record.update(n_params=n_params, launches=launches, first_call_s=first_s,
                  peak_memory_gb=peak_gb)
    del out

    # 5. small-input reference: card (kernels) vs CPU (plain versions), fp32
    small = scaled_config(cfg)
    cpu_model = seeded_init_(build_model(small), args.seed).eval()
    gpu_model = seeded_init_(build_model(small), args.seed).to(dev).eval()
    xs = torch.rand((1, 2, 1, 64, 64), generator=torch.Generator().manual_seed(args.seed + 2))
    before = launch_counts()
    with torch.inference_mode():
        want = cpu_model(xs, return_intermediate=True)
        got = gpu_model(xs.to(dev), return_intermediate=True)
    after = launch_counts()
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
    if any(after[k] <= before[k] for k in EXPECTED_LAUNCHES):
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
    rows = time_kernels(dev, args.seed, KERNELS, _inputs, _fns)

    # 7. gradient kernels against their plain versions, then their times
    log("[7] gradient kernels vs plain versions (bf16 and fp32)")
    worst.update(check_kernels(dev, args.seed, TRAIN_KERNELS, _train_inputs, _train_fns,
                               scaled=True))
    rows.update(time_kernels(dev, args.seed, TRAIN_KERNELS, _train_inputs, _train_fns))
    record["max_abs_err"] = worst
    record["kernel_ms"] = {f"{n} {s}": {"ms": a, "plain_ms": b} for (n, s), (a, b) in rows.items()}
    record["after_timing"] = nvidia_smi("clocks.sm,power.draw,temperature.gpu")
    torch.cuda.empty_cache()

    # 8. small training reference; 9. the training slice
    record["train_reference"] = train_reference(cfg, dev, args.seed)
    record["train"] = train_full_width(cfg, dev, args.seed)
    step3 = record["train"]["stage3"]["launches_per_step"]

    kernels = []
    for name, spec in {**KERNELS, **TRAIN_KERNELS}.items():
        ms, plain_ms = rows[(name, spec["hot"])]
        kernels.append({"name": name, "route": "cuda", "source": spec["source"],
                        "replaces": spec["replaces"],
                        # inference kernels: the reconstruct run [4]; gradient
                        # kernels: one stage-3 train step [9]
                        "launches": launches[name] if name in launches else step3[name],
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
