"""The cascade's staged training step (counterpart of
hybrid_vit_cascade_tpu/training/trainer.py: ``make_train_step`` :130-185,
``make_eval_step`` :188-204, ``resize_target`` :207 and the per-stage set-up
of ``Trainer.fit_cascade`` :648-732).

A step is ``(state, batch, generator) → (state, metrics)``: one forward of
the cascade in train mode (batch-statistics BatchNorm with running-statistic
updates, dropout seeded from ``generator``), the loss dict of
``MultiScaleLoss`` (the JAX keys), one backward and one optimizer update.
``batch`` holds ``drr_stacked`` (B, 2, 1, S, S) and ``ct_volume``
(B, 1, D, H, W). Not ported yet: the ``Trainer`` class with its epoch and
evaluation loops and logs, ``CheckpointManager``, the data loader, the split
stage-3 step and the ``freeze_shared_encoder_stage3`` arm (its pinned
BatchNorm statistics).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..losses.metrics import psnr, ssim_metric
from ..losses.multiscale import MultiScaleLoss, l1_loss
from ..ops.resize import resize_trilinear
from .schedules import apply_stage_freeze, make_optimizer


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def resize_target(volume: torch.Tensor, resolution: Sequence[int]) -> torch.Tensor:
    """The full-resolution CT target at a stage's resolution
    (trilinear, align_corners=False)."""
    return resize_trilinear(volume, tuple(resolution), align_corners=False)


def make_train_step(model: nn.Module, loss_fn: Callable, model_kwargs: Optional[Dict] = None,
                    train: bool = True):
    """loss_fn(pred, batch) → dict with 'total_loss'. Returns
    step(state, batch, generator) → (state, metrics).

    ``train=False`` runs the deterministic forward (running statistics, no
    dropout) — the form in which a step can be held to the JAX package's."""
    mkw = dict(model_kwargs or {})

    def step(state: TrainState, batch: Dict, generator: Optional[torch.Generator]):
        state.optimizer.zero_grad(set_to_none=True)
        pred = model(batch["drr_stacked"], train=train, generator=generator if train else None,
                     **mkw)
        metrics = loss_fn(pred, batch)
        metrics["total_loss"].float().backward()
        state.optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def make_eval_step(model: nn.Module, target_fn: Callable, model_kwargs: Optional[Dict] = None):
    """step(batch) → {'loss': l1, 'psnr', 'ssim'} of the deterministic forward."""
    mkw = dict(model_kwargs or {})

    @torch.no_grad()
    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        pred = model(batch["drr_stacked"], train=False, **mkw)
        target = target_fn(batch)
        return {"loss": l1_loss(pred, target), "psnr": psnr(pred, target),
                "ssim": ssim_metric(pred, target)}

    return step


def stage_step(model: nn.Module, cfg, stage: int, loss_obj: Optional[MultiScaleLoss] = None,
               steps_per_epoch: int = 1, train: bool = True):
    """What ``Trainer.fit_cascade`` builds for stage ``stage`` (1-3): freezes
    every parameter but that stage's (and, for stages 2-3, the shared
    ``xray_encoder``'s), an optimizer over the rest with the stage's learning
    rate and schedule length, the stage's loss at its target resolution, and
    the train step with ``max_stage=stage`` and ``stop_grad_stage1`` from
    stage 2 on. Returns (state, step)."""
    t = cfg.training
    if stage == 3 and t.freeze_shared_encoder_stage3:
        raise NotImplementedError("freeze_shared_encoder_stage3 (pinned encoder statistics, "
                                  "split stage-3 step) is not ported yet")
    sc = t.stages[f"stage{stage}"]
    if loss_obj is None:
        loss_obj = MultiScaleLoss({"stage1": cfg.loss.stage1, "stage2": cfg.loss.stage2,
                                   "stage3": cfg.loss.stage3}, vgg_weights=cfg.loss.vgg_weights)
    trainable = [f"stage{stage}"] + (["xray_encoder"] if stage >= 2 else [])
    params = apply_stage_freeze(model, trainable)
    opt = make_optimizer(params, sc.learning_rate, steps_per_epoch * sc.num_epochs,
                         t.weight_decay, t.gradient_clip)
    resolution = tuple(sc.target_resolution)

    def loss_fn(pred, batch):
        target = resize_target(batch["ct_volume"], resolution)
        xr = batch["drr_stacked"] if stage == 3 else None
        return loss_obj(pred, target, stage=stage, input_xrays=xr)

    step = make_train_step(model, loss_fn, {"max_stage": stage, "stop_grad_stage1": stage >= 2},
                           train=train)
    return TrainState(model, opt), step
