"""Optimizer, learning-rate schedule and stage freezing (counterpart of
hybrid_vit_cascade_tpu/training/schedules.py).

``make_optimizer`` reproduces the JAX package's optax chain —
``clip_by_global_norm(clip)`` then ``adamw(schedule, weight_decay)`` — with
``torch.optim.AdamW`` and ``clip_grad_norm_`` run by step hooks:
- the global norm is taken over the gradients of the trainable parameters
  only (the JAX ``multi_transform`` hands the clip just the 'train' subtree);
  torch scales by clip / (norm + 1e-6), optax by clip / norm;
- torch's AdamW is optax's: eps = 1e-8 outside the square root, decoupled
  weight decay p·(1 − lr·wd);
- the learning rate of step t (counted from 0, so the first step uses the
  peak) follows cosine decay to 0 over ``total_steps``, after an optional
  linear warmup from 0.

Stage freezing is ``requires_grad`` plus the optimizer's parameter list:
frozen parameters get no gradient, no update and no weight decay — what the
optax ``set_to_zero`` branch does to them.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Sequence

import torch
import torch.nn as nn

from ..parallel.mesh import all_reduce_grads, ambient_group


def cosine_schedule(learning_rate: float, total_steps: int,
                    warmup_steps: int = 0) -> Callable[[int], float]:
    """optax ``cosine_decay_schedule(lr, max(total_steps, 1))``, or with
    warmup ``warmup_cosine_decay_schedule(0, lr, warmup, max(total, warmup + 1))``."""
    if warmup_steps > 0:
        decay = max(total_steps, warmup_steps + 1) - warmup_steps

        def schedule(count: int) -> float:
            if count < warmup_steps:
                return learning_rate * count / warmup_steps
            t = min(count - warmup_steps, decay)
            return learning_rate * 0.5 * (1.0 + math.cos(math.pi * t / decay))
        return schedule
    decay = max(total_steps, 1)

    def schedule(count: int) -> float:
        return learning_rate * 0.5 * (1.0 + math.cos(math.pi * min(count, decay) / decay))
    return schedule


def make_optimizer(params: Iterable[torch.Tensor], learning_rate: float, total_steps: int,
                   weight_decay: float = 0.01, gradient_clip: float = 1.0,
                   warmup_steps: int = 0) -> torch.optim.AdamW:
    """AdamW + cosine decay to 0 over total_steps (+ optional warmup) with
    global-norm clipping over exactly ``params`` (the trainable ones). Its
    ``step()`` averages the gradients over the ambient data group
    (``parallel.mesh.use_data_group``; nothing without one), clips them in
    place, updates, then sets the next step's learning rate.

    The schedule's step count lives in each parameter group
    (``"schedule_step"``), so ``state_dict`` carries it and
    ``load_state_dict`` resumes the schedule where it stopped, with the
    learning rate this optimizer's schedule gives at that count (as optax
    keeps the count in its state and takes the schedule from the rebuilt
    chain). The hooks set the rate themselves rather than through
    ``LambdaLR``: a scheduler holds its optimizer, so a hook holding the
    scheduler would make a reference cycle that keeps the Adam moments alive
    after the optimizer is dropped, until the garbage collector runs."""
    params = list(params)
    schedule = cosine_schedule(learning_rate, total_steps, warmup_steps)
    opt = torch.optim.AdamW(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay,
                            fused=bool(params) and all(p.is_cuda for p in params))
    for group in opt.param_groups:
        group["schedule_step"] = 0

    def sync(*_) -> None:
        all_reduce_grads(params, ambient_group())

    def clip(*_) -> None:
        torch.nn.utils.clip_grad_norm_(params, gradient_clip, foreach=True)

    def advance(optimizer: torch.optim.Optimizer, *_) -> None:
        for group in optimizer.param_groups:
            group["schedule_step"] += 1
            group["lr"] = schedule(group["schedule_step"])

    def resume(optimizer: torch.optim.Optimizer) -> None:
        for group in optimizer.param_groups:
            group["lr"] = schedule(group.get("schedule_step", 0))

    opt.register_step_pre_hook(sync)  # pre-hooks run in order: clip sees the average
    opt.register_step_pre_hook(clip)
    opt.register_step_post_hook(advance)
    opt.register_load_state_dict_post_hook(resume)
    return opt


def stage_freeze_labels(model: nn.Module, trainable_prefixes: Sequence[str]) -> Dict[str, str]:
    """'train' / 'freeze' per parameter name, by the prefix of its top-level
    submodule name (the JAX function labels top-level param subtrees)."""
    return {name: ("train" if any(name.split(".", 1)[0].startswith(p) for p in trainable_prefixes)
                   else "freeze")
            for name, _ in model.named_parameters()}


def apply_stage_freeze(model: nn.Module, trainable_prefixes: Sequence[str]) -> List[nn.Parameter]:
    """Set ``requires_grad`` from ``stage_freeze_labels`` and return the
    trainable parameters, in name order, for the optimizer."""
    labels = stage_freeze_labels(model, trainable_prefixes)
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == "train")
        if p.requires_grad:
            trainable.append(p)
    return trainable
