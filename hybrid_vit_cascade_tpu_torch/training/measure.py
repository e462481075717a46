"""Time, profile and size a train step: the cascade's staged one, a
diffusion ladder stage's, or the single-model step of the other families.

    python -m hybrid_vit_cascade_tpu_torch.training.measure --stage 3 --batch 1 --steps 3 --profile
    python -m hybrid_vit_cascade_tpu_torch.training.measure --config configs/direct128_h200.json --batch 2
    python -m hybrid_vit_cascade_tpu_torch.training.measure --config configs/diffusion_quality_r5.json --stage 2 --batch 2

Builds the model of ``--config`` (default ``configs/progressive_cascade.json``,
full width) with weights from ``--seed``, feeds seeded X-rays
(B, 2, 1, S, S) and a seeded CT volume (B, 1, D, H, W) at the dataset's
resolution (256³ for the cascade) in [-1, 1], and runs one warm-up step and
``--steps`` timed steps of the step that ``stage_step`` builds for
``--stage`` (the cascade), ``diffusion_steps`` builds for the ladder's stage
``--stage`` (the diffusion family: that stage's trainable set, a refiner
conditioned on the ground truth at the previous stage's size) or
``single_model_step`` builds (the others).
``--deterministic`` runs that step with ``train=False`` (running
statistics, no dropout). ``--stage3-schedule dense``
runs the stage-3 conv chains densely (``stage3_slab_scan`` off, eval schedule
'train'), to set beside the config's streamed schedule. For a CNN decoder,
``--decoder-remat rdbs`` recomputes only its ResidualDenseBlocks, not each
upsample stage around them, to set beside the decoders' nested form, and
``--channels-last`` lays its 3D conv weights out as ``channels_last_3d``
(cuDNN then gives channels-last activations), to set beside NCDHW;
``--no-loss-remat`` builds its ``Direct256Loss`` without the nets' recompute
(the decoder keeps its own), to set beside the default.
``--profile`` runs
one more step under ``torch.profiler`` and adds the device time of each
kernel name; ``--memory`` profiles one more step's allocations and lists
what is allocated at its peak, by the code that allocated it.
A step that runs out of the card's memory ends the run with the
allocator's numbers under ``out_of_memory`` (and exit code 1).
Prints one JSON object (and writes it to ``--out`` if given). Needs a CUDA
card; ``train_steps`` also runs on the CPU at a small config.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.nn as nn

from ..config import data_volume_size
from ..losses.multiscale import MultiScaleLoss
from ..ops.cuda import launch_counts, reset_launch_counts
from .trainer import diffusion_state, diffusion_steps, single_model_step, stage_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


TOP_KERNELS = 25  # kernel names a profile lists


def kernel_profile(fn, dev: torch.device) -> Dict:
    """Run ``fn()`` once under torch.profiler: wall time, summed device
    kernel time, the share of the wall in which no kernel ran, the
    TOP_KERNELS kernel names by device time, and in ``own`` every kernel of
    the port's sources (``csrc/``, all in anonymous namespaces) by device
    time, however small."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    _sync(dev)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (end - start) / 1e3, n + 1)
    busy_us, last = 0.0, None
    for start, end in sorted(spans):  # union of kernel intervals
        if last is None or start > last:
            busy_us += end - start
            last = end
        elif end > last:
            busy_us += end - last
            last = end
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"wall_ms": wall_ms, "kernel_ms": sum(ms for ms, _ in by_name.values()),
            "busy_ms": busy_us / 1e3, "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "top": [{"name": k, "ms": ms, "launches": n} for k, (ms, n) in kernels[:TOP_KERNELS]],
            "own": [{"name": k, "ms": ms, "launches": n} for k, (ms, n) in kernels
                    if k.removeprefix("void ").startswith("(anonymous namespace)::")]}


TOP_SITES = 15  # allocation sites a memory report lists


def _alloc_site(parents) -> str:
    """Where a block was allocated, from the profiler events that enclose its
    allocation (outermost first): the innermost Python frame in this package,
    the autograd node the engine was running (backward) and the innermost
    aten op."""
    frame = next((n for n in reversed(parents) if "hybrid_vit_cascade_tpu_torch/" in n), None)
    node = next((n.split(": ", 1)[1] for n in reversed(parents)
                 if n.startswith("autograd::engine::evaluate_function: ")), None)
    op = next((n for n in reversed(parents) if n.startswith("aten::")), None)
    parts = [frame.split("hybrid_vit_cascade_tpu_torch/", 1)[1] if frame else "-",
             f"bwd {node}" if node else "fwd", op or "-"]
    return " | ".join(parts)


def memory_peak(fn, dev: torch.device) -> Dict:
    """Run ``fn()`` once under torch.profiler with memory events and Python
    frames; replay the card's allocations to the moment of the most memory
    allocated and group the blocks live then by ``_alloc_site``. 'before the
    step' is what was allocated when ``fn`` began and is still live (weights,
    optimizer state, batch). If ``fn`` runs out of memory, the peak is the
    last allocation that succeeded, and ``out_of_memory`` holds oom_record's
    numbers. (The allocator's own history recorder is not
    used: with Python or C++ stacks it made Function.apply fail inside a
    checkpoint's recompute, torch 2.11 on an H100.)"""
    from torch._C._profiler import _EventType
    from torch.profiler import ProfilerActivity, profile

    _sync(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    oom = None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], profile_memory=True,
                 with_stack=True) as prof:
        try:
            fn()
        except torch.cuda.OutOfMemoryError as e:
            oom = oom_record(e, dev)
        _sync(dev)
    events = []  # (time, ptr, signed size, allocated after, site)
    stack = [(root, ()) for root in prof.profiler.kineto_results.experimental_event_tree()]
    while stack:
        node, parents = stack.pop()
        if node.typed[0] == _EventType.Allocation:
            f = node.typed[1]
            if f.device.type == "cuda":
                events.append((node.start_time_ns, f.id, f.ptr, f.alloc_size, f.total_allocated,
                               parents))
        chain = parents + (node.name,)
        stack.extend((c, chain) for c in node.children)
    events.sort(key=lambda e: (e[0], e[1]))
    peak_i = max(range(len(events)), key=lambda i: events[i][4]) if events else -1
    live, freed_before = {}, 0
    for _, _, ptr, size, _, parents in events[:peak_i + 1]:
        if size > 0:
            live[ptr] = (size, parents)
        elif live.pop(ptr, None) is None:
            freed_before -= size
    sites = {"before the step": [before - freed_before, 0, {}]}
    for size, parents in live.values():
        entry = sites.setdefault(_alloc_site(parents), [0, 0, {}])
        entry[0] += size
        entry[1] += 1
        entry[2][size] = entry[2].get(size, 0) + 1
    top = sorted(sites.items(), key=lambda kv: -kv[1][0])[:TOP_SITES]
    return {"out_of_memory": oom, "peak_gb": events[peak_i][4] / 1e9 if events else None,
            "max_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "before_gb": before / 1e9, "alloc_events": len(events), "peak_event": peak_i,
            "at_peak": [{"site": k, "gb": b / 1e9, "blocks": n,
                         "largest_blocks_gb": [[sz / 1e9, c] for sz, c in
                                               sorted(sizes.items(), reverse=True)[:3]]}
                        for k, (b, n, sizes) in top]}


# the port's frames oom_record keeps of a failed call
OOM_FRAMES = 6


def oom_record(err: Exception, dev: torch.device) -> Dict:
    """The allocator's numbers where a step ran out of memory: the error's
    first line (the request, the card's capacity, what PyTorch held), the
    allocated, peak and reserved GB then, and the port's innermost frames
    of the failed call ("file:line function", innermost last)."""
    frames = [f for f in traceback.extract_tb(err.__traceback__)
              if "hybrid_vit_cascade_tpu_torch" in f.filename]
    return {"error": str(err).strip().splitlines()[0],
            "where": [f"{Path(f.filename).name}:{f.lineno} {f.name}" for f in frames[-OOM_FRAMES:]],
            "allocated_gb": torch.cuda.memory_allocated(dev) / 1e9,
            "max_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "reserved_gb": torch.cuda.memory_reserved(dev) / 1e9,
            "card_gb": torch.cuda.get_device_properties(dev).total_memory / 1e9}


def use_dense_stage3(model: nn.Module) -> None:
    """Run the stage-3 conv chains densely in every call: stage3_slab_scan
    off and stage3_eval_schedule 'train' (the same weights; only the
    schedule changes)."""
    model.stage3.slab_scan = False
    model.stage3.eval_schedule = "train"


def use_rdb_remat(model: nn.Module) -> None:
    """A CNN decoder's upsample stages recompute their ResidualDenseBlocks
    only, not the stage as a whole (one recompute of each RDB a step, against
    two when nested)."""
    model._stage = lambda name, x, train: getattr(model, name)(x, model.remat and train)


def use_channels_last(model: nn.Module) -> None:
    """A CNN decoder's 3D conv weights laid out as ``channels_last_3d``."""
    for p in model.parameters():
        if p.dim() == 5:
            p.data = p.data.contiguous(memory_format=torch.channels_last_3d)


def train_steps(model: nn.Module, cfg, stage: Optional[int], batch_size: int, steps: int,
                generator: torch.Generator, train: bool = True,
                loss_obj: Optional[MultiScaleLoss] = None, profile: bool = False,
                memory: bool = False, allow_oom: bool = False) -> Dict:
    """One warm-up step and ``steps`` timed steps of the cascade's stage
    ``stage``, of the diffusion ladder's stage ``stage`` (1-based), or
    (another family) its single-model step (``stage`` unread; ``loss_obj``
    is read by the cascade only) on the model's device, on a batch drawn from
    ``generator`` (which also seeds dropout). Returns step times (ms, host
    clock around work that ends in a device sync), total_loss per step
    (warm-up first) and every metric of the step's (``metrics``, per step),
    peak memory (GB, CUDA only), kernel launches of the warm-up step, with ``profile`` the kernel profile of one more step and
    with ``memory`` (CUDA only) what is allocated at the peak of one more
    step. With ``allow_oom``, a step that runs out of the card's memory ends
    the run with ``out_of_memory`` (``oom_record``) in place of an error, and
    ``memory`` then profiles one more step up to its failed allocation."""
    dev = next(model.parameters()).device
    xs = cfg.data.xray_size
    batch = {"drr_stacked": torch.rand((batch_size, 2, 1, xs, xs), generator=generator,
                                       device=dev) * 2 - 1,
             "ct_volume": torch.rand((batch_size, 1, *data_volume_size(cfg)),
                                     generator=generator, device=dev) * 2 - 1}
    t = cfg.training
    if cfg.model.family == "cascade":
        state, step = stage_step(model, cfg, stage, loss_obj, steps_per_epoch=1, train=train)
    elif cfg.model.family == "diffusion":
        idx = stage - 1
        state = diffusion_state(model, cfg, idx, t.learning_rate, t.num_epochs,
                                t.freeze_shared_diffusion)
        step = diffusion_steps(model, idx, t.diffusion_sample_steps, train=train)[0]
    else:
        # one step an epoch, as stage_step is given: the schedule runs over
        # training.num_epochs steps
        state, step = single_model_step(model, cfg, cfg.training.num_epochs,
                                        cfg.training.learning_rate, train=train)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    reset_launch_counts()
    out = {"trainable_params": sum(p.numel() for p in model.parameters() if p.requires_grad),
           "total_loss": [], "step_ms": [], "metrics": []}
    try:
        for i in range(1 + steps):  # a warm-up step, then the timed ones
            t0 = time.perf_counter()
            state, metrics = step(state, batch, generator)
            _sync(dev)
            if i == 0:
                out.update(warmup_s=time.perf_counter() - t0, launches_per_step=launch_counts())
            else:
                out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            out["total_loss"].append(float(metrics["total_loss"]))
            out["metrics"].append({k: float(v) for k, v in metrics.items()})
    except torch.cuda.OutOfMemoryError as e:
        if dev.type != "cuda" or not allow_oom:
            raise
        out["out_of_memory"] = oom_record(e, dev)
    if out["step_ms"]:
        out["steps_per_sec"] = 1e3 / statistics.median(out["step_ms"])
    if dev.type == "cuda":
        out["peak_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out["peak_reserved_gb"] = torch.cuda.max_memory_reserved(dev) / 1e9
    if "out_of_memory" in out:
        torch.cuda.empty_cache()
        if memory:
            out["memory"] = memory_peak(lambda: step(state, batch, generator), dev)
        return out
    if profile:
        out["profile"] = kernel_profile(lambda: step(state, batch, generator), dev)
    if memory:
        out["memory"] = memory_peak(lambda: step(state, batch, generator), dev)
    return out


def main(argv=None) -> int:
    from ..config import Config
    from ..inference.infer import build_model
    from ..models.layers import seeded_init_

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="configs/progressive_cascade.json")
    ap.add_argument("--stage", type=int, choices=(1, 2, 3), default=None,
                    help="the cascade's or the diffusion ladder's stage (required for "
                         "those, unread otherwise)")
    ap.add_argument("--batch", type=int, required=True)
    ap.add_argument("--steps", type=int, default=3, help="timed steps after one warm-up step")
    ap.add_argument("--seed", type=int, default=0, help="seed of weights, inputs and dropout")
    ap.add_argument("--deterministic", action="store_true",
                    help="train=False: running statistics, no dropout")
    ap.add_argument("--stage3-schedule", choices=("config", "dense"), default="config",
                    help="the config's stage-3 chain schedule, or the dense one")
    ap.add_argument("--decoder-remat", choices=("nested", "rdbs"), default="nested",
                    help="a CNN decoder's recompute: stages and RDBs, or the RDBs alone")
    ap.add_argument("--channels-last", action="store_true",
                    help="a CNN decoder's 3D conv weights as channels_last_3d")
    ap.add_argument("--no-loss-remat", action="store_true",
                    help="a CNN decoder's Direct256Loss without its nets' recompute")
    ap.add_argument("--profile", action="store_true", help="profile one more step")
    ap.add_argument("--memory", action="store_true",
                    help="list what is allocated at the peak of one more step")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("measure: no CUDA device; the full-width step runs only on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = Config.from_json(args.config)
    if cfg.model.family in ("cascade", "diffusion") and args.stage is None:
        sys.exit("measure: --stage is required for the cascade and the diffusion ladder")
    model = seeded_init_(build_model(cfg), args.seed).to(dev)
    if args.no_loss_remat:  # read by single_model_step's loss; the model is built
        cfg.model.use_gradient_checkpointing = False
    if args.stage3_schedule == "dense":
        use_dense_stage3(model)
    if args.decoder_remat == "rdbs":
        use_rdb_remat(model)
    if args.channels_last:
        use_channels_last(model)
    loss_obj = MultiScaleLoss({f"stage{n}": getattr(cfg.loss, f"stage{n}") for n in (1, 2, 3)})
    g = torch.Generator(device=dev).manual_seed(args.seed + 10 + (args.stage or 0))
    res = train_steps(model, cfg, args.stage, args.batch, args.steps, g,
                      train=not args.deterministic, loss_obj=loss_obj, profile=args.profile,
                      memory=args.memory, allow_oom=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    res.update(stage=args.stage, batch=args.batch, train=not args.deterministic, card=card,
               stage3_schedule=args.stage3_schedule, decoder_remat=args.decoder_remat,
               channels_last=args.channels_last, loss_remat=not args.no_loss_remat,
               torch=torch.__version__)
    text = json.dumps(res, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 1 if "out_of_memory" in res else 0


if __name__ == "__main__":
    sys.exit(main())
