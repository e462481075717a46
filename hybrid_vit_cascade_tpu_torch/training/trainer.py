"""Training (counterpart of hybrid_vit_cascade_tpu/training/trainer.py):
``make_train_step`` :130-185, ``make_eval_step`` :188-204, ``resize_target``
:207, ``host_target_transform`` :215-267 and the ``Trainer`` with ``fit``
:364-397 (the single-model families), ``fit_cascade`` :632-748,
``_carry_best`` :750-757 and ``_run_epochs`` :760-863.

A step is ``(state, batch, generator) → (state, metrics)``: one forward of
the cascade in train mode (batch-statistics BatchNorm with running-statistic
updates, dropout seeded from ``generator``), the loss dict of
``MultiScaleLoss`` (the JAX keys), one backward and one optimizer update.
``batch`` holds ``drr_stacked`` (B, 2, 1, S, S) and ``ct_volume``
(B, 1, D, H, W). ``stage_step`` builds what ``fit_cascade`` builds per stage,
the frozen-encoder stage 3 (``freeze_shared_encoder_stage3``: encoder out of
the optimizer, its BatchNorm running statistics pinned) and its split step
(``stage3_split_step``) included.

``single_model_step`` builds what ``fit`` builds for ``direct_vit`` and the
three CNN decoders: every parameter trainable, the loss at the dataset's
resolution (``MultiScaleLoss`` stage 1 for ``direct_vit``,
``Direct256Loss`` for the decoders).

The diffusion family (``diffusion_stage_configs`` :99-118,
``_diffusion_steps`` :414-485, ``fit_diffusion`` :501-519,
``fit_diffusion_cascade`` :521-630): ``diffusion_steps`` builds one stage's
train step (the model's sampled-t loss in train mode; a refiner conditioned
on the ground truth resized to the previous stage's size) and eval step (the
loss and a DDIM reconstruction's PSNR and SSIM); ``diffusion_state`` its
trainable set and optimizer; ``fit`` trains the ladder's last stage
(``fit_diffusion``) or the ladder (``fit_diffusion_cascade``, with its
cascaded-DDIM chain evaluation) by ``training.diffusion_progressive``.

Observability (JAX ``trainer.py:287-292``, ``:777-798``, ``:844-951``):
``training.use_wandb`` logs each epoch's row through ``utils/wandb_compat.py``
(a silent no-op without wandb); ``training.profile_dir`` records the first
epoch of each fit loop's training under ``torch.profiler`` (CPU and, on the
card, CUDA activity) and writes one Chrome trace a phase,
``<profile_dir>/<phase>_epoch<NNN>.json``; ``training.debug_nans`` raises
``FloatingPointError`` at the first step whose loss or gradient is not finite
(JAX's ``jax_debug_nans`` stops at the first op that makes a NaN; here the
check is once a step, one host sync a step when set); ``training.viz_every``
writes the epoch-end figures of ``_viz_epoch`` (``fit`` and
``fit_cascade``, as in JAX) under ``save_dir/viz/epoch_NNN``, and a figure
that fails (no matplotlib) prints ``[viz] epoch N visualization failed: ...``
while training goes on.

Data parallelism (JAX ``trainer.py:293``, ``_mesh_for_batch`` :323-336,
``_run_epochs`` :763-861), one process per card under torchrun: the
``Trainer`` starts the process group (``parallel.mesh.init_from_env``) and
each stage trains on ``data_group(batch)``, the first gcd(batch, world)
ranks, each on its part of the stage's global batch (``DataLoader`` rank and
world). Inside the stage's steps the group is ambient: the train-mode
BatchNorm normalises over the global batch, the TV loss takes the global
means and the optimizer averages the gradients before it clips. A rank
outside the group skips the steps but joins the barriers, and rank 0's
state is broadcast when such a stage ends. Dropout draws from the seed of
(step, rank). ``train_loss`` and the validation metrics are averaged over
the group (a validation batch that does not divide is evaluated whole on
every rank) and agree on every rank, so every rank takes the same
best-checkpoint decisions; rank 0 alone writes checkpoints, logs, wandb
rows, figures and profiler traces. Not ported: the model axis and multiple
hosts.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..config import Config, data_volume_size, validate_config
from ..data import native_io
from ..data.dataset import PatientDRRDataset, create_train_val_datasets
from ..data.pipeline import DataLoader, to_device
from ..data.synthetic import SyntheticCTDataset
from ..inference.infer import build_model
from ..losses.direct256 import Direct256Loss
from ..losses.metrics import mse, psnr, psnr_of_mse, ssim_metric
from ..losses.multiscale import MultiScaleLoss, l1_loss
from ..ops.resize import resize_trilinear, resize_trilinear_np
from ..parallel.mesh import (
    DataGroup,
    all_reduce_mean,
    broadcast_module,
    broadcast_object,
    data_group,
    init_from_env,
    is_main,
    rank,
    use_data_group,
    world,
)
from ..utils.logging import CSVLogger, JSONLLogger
from .checkpoint import CheckpointManager
from .schedules import apply_stage_freeze, make_optimizer


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def diffusion_stage_configs(m) -> tuple:
    """The diffusion stage ladder (JAX ``trainer.py:99-118``): 64³ / 128³ /
    256³ at depths 4 / 6 / 8 and heads 4 / 8 / 8 whatever the config says,
    truncated to the configured volume size; below 64, one stage at the
    config's size, depth and heads."""
    ladder = [
        dict(name="stage1_low", volume_size=(64, 64, 64), voxel_dim=m.voxel_dim,
             vit_depth=4, num_heads=4, use_depth_lifting=True, use_physics_loss=True),
        dict(name="stage2_mid", volume_size=(128, 128, 128), voxel_dim=m.voxel_dim,
             vit_depth=6, num_heads=8, use_depth_lifting=True, use_physics_loss=True),
        dict(name="stage3_high", volume_size=(256, 256, 256), voxel_dim=m.voxel_dim,
             vit_depth=8, num_heads=8, use_depth_lifting=True, use_physics_loss=True),
    ]
    top = max(m.volume_size)
    if top < 64:
        return (dict(name="stage1_low", volume_size=tuple(m.volume_size), voxel_dim=m.voxel_dim,
                     vit_depth=m.vit_depth, num_heads=m.num_heads, use_depth_lifting=True,
                     use_physics_loss=True),)
    return tuple(c for c in ladder if max(c["volume_size"]) <= top)


def resize_target(volume: torch.Tensor, resolution: Sequence[int]) -> torch.Tensor:
    """The full-resolution CT target at a stage's resolution
    (trilinear, align_corners=False)."""
    return resize_trilinear(volume, tuple(resolution), align_corners=False)


def _buffers(model: nn.Module, prefixes: Sequence[str]) -> list:
    """The buffers (BatchNorm running statistics) of the top-level submodules
    whose names start with one of ``prefixes``."""
    return [b for name, b in model.named_buffers()
            if name.split(".", 1)[0].startswith(tuple(prefixes))]


@contextlib.contextmanager
def _restored(buffers: Iterable[torch.Tensor]):
    """Put ``buffers`` back to their values at entry, bitwise, on exit: the
    running-statistic updates made inside (forwards and activation-checkpoint
    recomputes alike) are discarded."""
    buffers = list(buffers)
    saved = [b.clone() for b in buffers]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in zip(buffers, saved):
                b.copy_(v)


def make_train_step(model: nn.Module, loss_fn: Callable, model_kwargs: Optional[Dict] = None,
                    train: bool = True, extra_inputs: Optional[Dict[str, str]] = None,
                    freeze_stats_prefixes: Optional[Sequence[str]] = None):
    """loss_fn(pred, batch) → dict with 'total_loss'. Returns
    step(state, batch, generator) → (state, metrics).

    ``train=False`` runs the deterministic forward (running statistics, no
    dropout) — the form in which a step can be held to the JAX package's.
    extra_inputs: {model kwarg: batch key}, e.g. the split stage-3 step's
    precomputed ``stage2_volume``. freeze_stats_prefixes: top-level
    submodules whose BatchNorm running statistics the step leaves bitwise
    unchanged (they still normalise with batch statistics in train mode)."""
    mkw = dict(model_kwargs or {})
    pinned = _buffers(model, freeze_stats_prefixes or ())

    def step(state: TrainState, batch: Dict, generator: Optional[torch.Generator]):
        state.optimizer.zero_grad(set_to_none=True)
        kw = dict(mkw, **{k: batch[b] for k, b in (extra_inputs or {}).items()})
        with _restored(pinned):
            pred = model(batch["drr_stacked"], train=train,
                         generator=generator if train else None, **kw)
            metrics = loss_fn(pred, batch)
            metrics["total_loss"].float().backward()
        state.optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def eval_metrics(loss: torch.Tensor, pred: torch.Tensor, target: torch.Tensor,
                 group: Optional[DataGroup] = None) -> Dict[str, torch.Tensor]:
    """{'loss', 'psnr', 'ssim'} of a validation batch; with the data group
    over which the batch is split, those of the global batch (the means
    averaged, PSNR from the averaged MSE)."""
    if group is None:
        return {"loss": loss, "psnr": psnr(pred, target), "ssim": ssim_metric(pred, target)}
    loss, mse_, ssim_ = all_reduce_mean(
        torch.stack([loss.float(), mse(pred, target), ssim_metric(pred, target)]), group).unbind()
    return {"loss": loss, "psnr": psnr_of_mse(mse_), "ssim": ssim_}


def make_eval_step(model: nn.Module, target_fn: Callable, model_kwargs: Optional[Dict] = None):
    """step(batch, group=None) → {'loss': l1, 'psnr', 'ssim'} of the
    deterministic forward (``eval_metrics``)."""
    mkw = dict(model_kwargs or {})

    @torch.no_grad()
    def step(batch: Dict, group: Optional[DataGroup] = None) -> Dict[str, torch.Tensor]:
        pred = model(batch["drr_stacked"], train=False, **mkw)
        target = target_fn(batch)
        return eval_metrics(l1_loss(pred, target), pred, target, group)

    return step


def stage_step(model: nn.Module, cfg, stage: int, loss_obj: Optional[MultiScaleLoss] = None,
               steps_per_epoch: int = 1, train: bool = True):
    """What ``Trainer.fit_cascade`` builds for stage ``stage`` (1-3): freezes
    every parameter but that stage's (and, for stages 2-3, the shared
    ``xray_encoder``'s, except at stage 3 under
    ``freeze_shared_encoder_stage3``, which also pins the encoder's BatchNorm
    running statistics), an optimizer over the rest with the stage's learning
    rate and schedule length, the stage's loss at its target resolution, and
    the train step with ``max_stage=stage`` and ``stop_grad_stage1`` from
    stage 2 on. With ``stage3_split_step`` (which requires the frozen
    encoder) the stage-3 step first runs stages 1-2 without gradients, in
    train mode with their BatchNorm updates discarded, and feeds the stage-2
    volume to a stage-3-only forward: exact, since nothing trainable lies
    upstream of it. Returns (state, step)."""
    t = cfg.training
    sc = t.stages[f"stage{stage}"]
    if t.stage3_split_step and stage == 3 and not t.freeze_shared_encoder_stage3:
        raise ValueError("stage3_split_step requires freeze_shared_encoder_stage3: with a "
                         "trainable shared encoder the precomputed stage-2 volume would "
                         "silently drop the encoder-through-stage-2 gradient")
    freeze_enc3 = stage == 3 and t.freeze_shared_encoder_stage3
    if loss_obj is None:
        loss_obj = MultiScaleLoss({"stage1": cfg.loss.stage1, "stage2": cfg.loss.stage2,
                                   "stage3": cfg.loss.stage3}, vgg_weights=cfg.loss.vgg_weights)
    trainable = [f"stage{stage}"] + (["xray_encoder"] if stage >= 2 and not freeze_enc3 else [])
    params = apply_stage_freeze(model, trainable)
    opt = make_optimizer(params, sc.learning_rate, steps_per_epoch * sc.num_epochs,
                         t.weight_decay, t.gradient_clip)
    resolution = tuple(sc.target_resolution)

    def loss_fn(pred, batch):
        target = resize_target(batch["ct_volume"], resolution)
        xr = batch["drr_stacked"] if stage == 3 else None
        return loss_obj(pred, target, stage=stage, input_xrays=xr)

    pinned = ("xray_encoder",) if freeze_enc3 else None
    if not (freeze_enc3 and t.stage3_split_step):
        step = make_train_step(model, loss_fn, {"max_stage": stage, "stop_grad_stage1": stage >= 2},
                               train=train, freeze_stats_prefixes=pinned)
        return TrainState(model, opt), step

    base = make_train_step(model, loss_fn, {"max_stage": 3}, train=train,
                           extra_inputs={"stage2_volume": "stage2_vol"},
                           freeze_stats_prefixes=pinned)
    stages12 = _buffers(model, ("stage1", "xray_encoder"))

    def split_step(state: TrainState, batch: Dict, generator: Optional[torch.Generator]):
        with torch.no_grad(), _restored(stages12):
            vol128 = model(batch["drr_stacked"], train=train, max_stage=2,
                           generator=generator if train else None)
        return base(state, {**batch, "stage2_vol": vol128}, generator)

    return TrainState(model, opt), split_step


def single_model_step(model: nn.Module, cfg, total_steps: int, learning_rate: float,
                      train: bool = True):
    """What ``Trainer.fit`` builds for a single-model family: AdamW over every
    parameter with the config's decay, clip and warmup and a cosine schedule
    over ``total_steps`` from ``learning_rate``; the loss against the batch's
    CT volume as it comes (the dataset holds it at the model's resolution):
    ``MultiScaleLoss`` with ``loss.stage1``'s weights at stage 1 for
    ``direct_vit``, ``Direct256Loss`` for the CNN decoders (its nets' layers
    recomputed in the backward with ``use_gradient_checkpointing``; their
    step on cuDNN's deterministic algorithms). Returns
    (state, step)."""
    t = cfg.training
    opt = make_optimizer(model.parameters(), learning_rate, total_steps, t.weight_decay,
                         t.gradient_clip, t.warmup_steps)
    if cfg.model.family == "direct_vit":
        loss_obj = MultiScaleLoss({"stage1": cfg.loss.stage1}, vgg_weights=cfg.loss.vgg_weights)
        loss_fn = lambda pred, batch: loss_obj(pred, batch["ct_volume"], stage=1)  # noqa: E731
        return TrainState(model, opt), make_train_step(model, loss_fn, train=train)
    d256 = Direct256Loss(remat=cfg.model.use_gradient_checkpointing)
    loss_fn = lambda pred, batch: d256(pred, batch["ct_volume"])  # noqa: E731
    return TrainState(model, opt), _cudnn_deterministic(make_train_step(model, loss_fn,
                                                                        train=train))


def _cudnn_deterministic(step: Callable) -> Callable:
    """``step`` with cuDNN held to its deterministic algorithms, the flag
    restored after. The CNN decoders and their loss nets are cuDNN convs,
    and with the flag off cuDNN's backward may add in a varying order: two
    runs of the 128³ decoder's step then part from the second step on
    (PERF.md §6); the JAX package's step repeats bitwise."""

    def run(*args, **kwargs):
        before = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            return step(*args, **kwargs)
        finally:
            torch.backends.cudnn.deterministic = before

    return run


def diffusion_trainable(stage_configs: Sequence[Dict], stage_idx: int,
                        freeze_shared: bool = False) -> list:
    """The top-level submodules a diffusion stage trains (JAX
    ``trainer.py:571-579``): its ``stage_{name}`` and ``prev_proj_{name}``,
    and the shared encoder and time MLP, which ``freeze_shared`` pins after
    the first stage."""
    name = stage_configs[stage_idx]["name"]
    if stage_idx > 0 and freeze_shared:
        return [f"stage_{name}", f"prev_proj_{name}"]
    return [f"stage_{name}", f"prev_proj_{name}", "xray_encoder", "Dense_0", "Dense_1"]


def diffusion_state(model: nn.Module, cfg, stage_idx: int, lr: float, total_steps: int,
                    freeze_shared: bool = False) -> TrainState:
    """The trainable set of a diffusion stage (``diffusion_trainable``)
    under AdamW with cosine decay over ``total_steps`` (no warmup, as the JAX
    trainer builds it); every other parameter frozen."""
    t = cfg.training
    params = apply_stage_freeze(
        model, diffusion_trainable(model.stage_configs, stage_idx, freeze_shared))
    return TrainState(model, make_optimizer(params, lr, total_steps, t.weight_decay,
                                            t.gradient_clip))


def diffusion_steps(model: nn.Module, stage_idx: int, sample_steps: int, train: bool = True):
    """One diffusion stage's (train_step, eval_step, resolution) (JAX
    ``_diffusion_steps``). A refiner stage is conditioned on the ground
    truth resized (align_corners=False) to the previous stage's size.

    train_step(state, batch, generator) → (state, metrics): the model's
    sampled-t loss in train mode (t, noise and dropout drawn from
    ``generator``), backward, optimizer step; metrics ``total_loss``,
    ``loss``, ``diffusion_loss``, ``physics_loss``. ``train=False`` runs that
    loss deterministically (running statistics, no dropout).
    eval_step(batch, group=None) → {loss, psnr, ssim}: the deterministic
    loss, and ``ddim_sample`` with ``sample_steps`` steps against the target
    (``eval_metrics``). Fixed
    generators stand where JAX has fixed keys: seed 0 for the loss, 1 for
    the sampler (their bits differ from JAX's)."""
    from ..models.diffusion import ddim_sample

    stage_cfgs = model.stage_configs
    stage = stage_cfgs[stage_idx]["name"]
    resolution = tuple(stage_cfgs[stage_idx]["volume_size"])
    prev_res = tuple(stage_cfgs[stage_idx - 1]["volume_size"]) if stage_idx > 0 else None

    def prev_of(batch):
        return None if prev_res is None else resize_target(batch["ct_volume"], prev_res)

    def train_step(state: TrainState, batch: Dict, generator: Optional[torch.Generator]):
        state.optimizer.zero_grad(set_to_none=True)
        x_start = resize_target(batch["ct_volume"], resolution)
        ld = model(x_start, batch["drr_stacked"], stage, generator,
                   prev_stage_volume=prev_of(batch), train=train)
        ld["loss"].backward()
        state.optimizer.step()
        state.step += 1
        ld = {k: v.detach() for k, v in ld.items()}
        return state, {"total_loss": ld["loss"], **ld}

    @torch.no_grad()
    def eval_step(batch: Dict, group: Optional[DataGroup] = None) -> Dict[str, torch.Tensor]:
        target = resize_target(batch["ct_volume"], resolution)
        prev = prev_of(batch)
        dev = target.device
        ld = model(target, batch["drr_stacked"], stage,
                   torch.Generator(device=dev).manual_seed(0), prev_stage_volume=prev)
        recon = ddim_sample(model, batch["drr_stacked"], stage,
                            torch.Generator(device=dev).manual_seed(1),
                            num_steps=sample_steps, prev_stage_volume=prev)
        return eval_metrics(ld["loss"], recon, target, group)

    return train_step, eval_step, resolution


def host_target_transform(resolution: Sequence[int], cache: bool = False):
    """DataLoader batch map: resize the CT target to the stage resolution on
    the host (the native threaded resample when ``native/libnifti_io.so``
    loads, else the numpy interpolation matrices), so a 64³ stage never copies
    the full 256³ volume to the card; ``resize_target`` then passes it
    through. Runs in the loader's prefetch thread. ``cache=True`` memoizes the
    resized target per patient id, which is right only when targets do not
    change between epochs (augmentation off)."""
    res = tuple(int(r) for r in resolution)
    memo: Optional[Dict] = {} if cache else None

    def resize_one(vol: np.ndarray) -> np.ndarray:
        """(..., D, H, W) → (..., *res), one volume at a time."""
        lead = vol.shape[:-3]
        flat = vol.reshape((-1,) + vol.shape[-3:]).astype(np.float32, copy=False)
        out = []
        for v3 in flat:
            r = native_io.resample_trilinear(v3, res, align_corners=False) \
                if native_io.available() else None
            out.append(r if r is not None else resize_trilinear_np(v3, res, align_corners=False))
        return np.stack(out).reshape(lead + res)

    def tf(batch: Dict) -> Dict:
        v = batch.get("ct_volume")
        if not (isinstance(v, np.ndarray) and tuple(v.shape[-3:]) != res):
            return batch
        batch = dict(batch)
        pids = batch.get("patient_id")
        if memo is not None and pids is not None:
            for i, pid in enumerate(pids):
                if pid not in memo:
                    memo[pid] = resize_one(v[i])
            batch["ct_volume"] = np.stack([memo[pid] for pid in pids])
        else:
            batch["ct_volume"] = resize_one(v)
        return batch

    return tf


class Trainer:
    """End-to-end training: ``Trainer(cfg).fit()``.

    The model is built from the config with torch's initialisers under
    ``training.seed`` and lives on ``device`` (the card unless the caller
    asks for the CPU; under torchrun, ``cuda:LOCAL_RANK``, with the process
    group started). The cascade's stage N writes its checkpoints to
    ``save_dir/stageN``, a single-model family to ``save_dir`` (``ckpt``);
    the CSV and JSONL logs go to ``save_dir/training_log.{csv,jsonl}``
    (rank 0's; ``csv`` and ``jsonl`` are None on the other ranks)."""

    def __init__(self, cfg: Config, device: str | torch.device = "cuda"):
        validate_config(cfg)
        t = cfg.training
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device; pass device='cpu' to train on the CPU")
        self.device = init_from_env(self.device)
        self.cfg = cfg
        main = is_main()
        if t.use_wandb and main:
            from ..utils import wandb_compat

            wandb_compat.init(config=cfg.to_dict())
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(t.seed)
            self.model = build_model(cfg).to(self.device)
        save_dir = cfg.checkpoints.save_dir
        self.ckpt = CheckpointManager(save_dir, cfg.checkpoints.save_every,
                                      cfg.checkpoints.keep_best)
        self.csv = CSVLogger(f"{save_dir}/training_log.csv") if main else None
        self.jsonl = JSONLLogger(f"{save_dir}/training_log.jsonl") if main else None
        self._build_data()

    def _build_data(self) -> None:
        d = self.cfg.data
        size = data_volume_size(self.cfg)
        if d.synthetic:
            ds = SyntheticCTDataset(num_patients=d.synthetic_patients, volume_size=size,
                                    xray_size=d.xray_size)
        else:
            ds = PatientDRRDataset(d.dataset_path, target_xray_size=d.xray_size,
                                   target_volume_size=size, normalization=d.normalization,
                                   augmentation=d.augmentation, cache_in_memory=d.cache_in_memory,
                                   max_patients=d.max_patients)
        self.train_ds, self.val_ds, self.test_ds = create_train_val_datasets(
            ds, d.train_split, d.val_split, seed=42, split_mode=d.split_mode)
        if len(self.val_ds) == 0:  # tiny datasets: validate on train
            self.val_ds = self.train_ds

    def fit(self, epochs: Optional[int] = None, lr_override: Optional[float] = None,
            resume: bool = True, progress: bool = True) -> Dict[str, float]:
        """The cascade trains stage by stage (``fit_cascade``), which, as in
        the JAX package, takes the epochs and learning rate of each stage
        from ``training.stages``: ``epochs`` and ``lr_override`` are not read.
        A single-model family trains ``epochs`` (default
        ``training.num_epochs``) at ``lr_override`` (default
        ``training.learning_rate``), resuming from ``latest`` with its
        optimizer state."""
        if self.cfg.model.family == "cascade":
            return self.fit_cascade(resume=resume, progress=progress)
        if self.cfg.model.family == "diffusion":
            if self.cfg.training.diffusion_progressive:
                return self.fit_diffusion_cascade(resume=resume, progress=progress)
            return self.fit_diffusion(epochs=epochs, progress=progress)
        t = self.cfg.training
        epochs = epochs if epochs is not None else t.num_epochs
        lr = lr_override if lr_override is not None else t.learning_rate
        steps_per_epoch = max(1, len(self.train_ds) // t.batch_size)
        state, train_step = single_model_step(self.model, self.cfg, steps_per_epoch * epochs, lr)
        start_epoch = self._restore_state(self.ckpt, state) if resume else 0
        eval_step = make_eval_step(self.model, lambda b: b["ct_volume"])
        return self._run_epochs(state, train_step, eval_step, t.batch_size, start_epoch, epochs,
                                lr, progress, "train", self.ckpt, None, viz_kwargs={})

    def fit_cascade(self, stages: Sequence[str] = ("stage1", "stage2", "stage3"),
                    resume: bool = True, progress: bool = True) -> Dict[str, float]:
        """Stagewise training with cross-run resume: each stage has its own
        checkpoint directory; on resume a completed stage is skipped (its best
        checkpoint carried on) and an in-progress one continues at its saved
        epoch with its optimizer state. Each finished stage hands its
        best-validation-PSNR weights to the next."""
        t = self.cfg.training
        loss_obj = MultiScaleLoss({"stage1": self.cfg.loss.stage1, "stage2": self.cfg.loss.stage2,
                                   "stage3": self.cfg.loss.stage3},
                                  vgg_weights=self.cfg.loss.vgg_weights)
        last: Dict[str, float] = {}
        for stage_name in stages:
            n = int(stage_name[-1])
            sc = t.stages[stage_name]
            steps_per_epoch = max(1, len(self.train_ds) // sc.batch_size)
            state, train_step = stage_step(self.model, self.cfg, n, loss_obj, steps_per_epoch)
            stage_ckpt = CheckpointManager(f"{self.cfg.checkpoints.save_dir}/{stage_name}",
                                           self.cfg.checkpoints.save_every)
            start_epoch = self._restore_state(stage_ckpt, state) if resume else 0
            if start_epoch >= sc.num_epochs:  # stage already complete
                self._carry_best(stage_ckpt)
                best = stage_ckpt.best
                last = {k: best.get(k, 0.0) for k in ("loss", "psnr", "ssim")}
                if progress and is_main():
                    print(f"[{stage_name}] complete at epoch {start_epoch - 1}; skipping")
                continue
            resolution = tuple(sc.target_resolution)
            eval_step = make_eval_step(
                self.model, lambda b, _res=resolution: resize_target(b["ct_volume"], _res),
                {"max_stage": n})
            last = self._run_epochs(state, train_step, eval_step, sc.batch_size, start_epoch,
                                    sc.num_epochs, sc.learning_rate, progress, stage_name,
                                    stage_ckpt, resolution, viz_kwargs={"max_stage": n})
            self._carry_best(stage_ckpt)
        return last

    def fit_diffusion(self, epochs: Optional[int] = None,
                      progress: bool = True) -> Dict[str, float]:
        """Train the ladder's last diffusion stage into ``save_dir``, from the
        model as built (no resume, as in JAX). A refiner stage is conditioned
        on the ground truth at the previous stage's size;
        ``fit_diffusion_cascade`` trains the ladder."""
        t = self.cfg.training
        epochs = epochs if epochs is not None else t.num_epochs
        stages = self.model.stage_configs
        idx = len(stages) - 1
        steps_per_epoch = max(1, len(self.train_ds) // t.batch_size)
        state = diffusion_state(self.model, self.cfg, idx, t.learning_rate,
                                steps_per_epoch * epochs)
        train_step, eval_step, resolution = diffusion_steps(self.model, idx,
                                                            t.diffusion_sample_steps)
        return self._run_epochs(state, train_step, eval_step, t.batch_size, 0, epochs,
                                t.learning_rate, progress, f"diffusion_{stages[idx]['name']}",
                                self.ckpt, resolution)

    def fit_diffusion_cascade(self, resume: bool = True,
                              progress: bool = True) -> Dict[str, float]:
        """Progressive diffusion training, stage by stage, each refiner
        conditioned on the ground truth at the previous stage's size, then a
        fully generated cascaded-DDIM evaluation on one validation item
        (``chain_{name}_psnr`` / ``_ssim``, logged to the JSONL as
        ``diffusion_chain_eval``). Per-stage epochs, batch and learning rate
        come from ``training.stages['stageN']`` by ladder position. A stage
        trains its own subtree and the shared encoder and time MLP (those
        only at stage 1 under ``freeze_shared_diffusion``); checkpoints go to
        ``save_dir/diffusion_{name}/``; a resumed run skips a completed stage.
        Each finished stage hands its best-validation-PSNR weights on."""
        from ..models.diffusion import cascaded_ddim_sample

        t = self.cfg.training
        stages = self.model.stage_configs
        last: Dict[str, float] = {}
        for i, sc_diff in enumerate(stages):
            name = sc_diff["name"]
            sc = t.stages.get(f"stage{i + 1}")
            epochs = sc.num_epochs if sc else t.num_epochs
            batch = sc.batch_size if sc else t.batch_size
            lr = sc.learning_rate if sc else t.learning_rate
            steps_per_epoch = max(1, len(self.train_ds) // batch)
            state = diffusion_state(self.model, self.cfg, i, lr, steps_per_epoch * epochs,
                                    t.freeze_shared_diffusion)
            stage_ckpt = CheckpointManager(f"{self.cfg.checkpoints.save_dir}/diffusion_{name}",
                                           self.cfg.checkpoints.save_every)
            start_epoch = self._restore_state(stage_ckpt, state) if resume else 0
            if start_epoch >= epochs:  # stage already complete
                self._carry_best(stage_ckpt)
                best = stage_ckpt.best
                last = {k: best.get(k, 0.0) for k in ("loss", "psnr", "ssim")}
                if progress and is_main():
                    print(f"[diffusion_{name}] complete at epoch {start_epoch - 1}; skipping")
                continue
            train_step, eval_step, resolution = diffusion_steps(self.model, i,
                                                                t.diffusion_sample_steps)
            last = self._run_epochs(state, train_step, eval_step, batch, start_epoch, epochs, lr,
                                    progress, f"diffusion_{name}", stage_ckpt, resolution)
            self._carry_best(stage_ckpt)

        item = self.val_ds[0]
        xr = torch.as_tensor(np.asarray(item["drr_stacked"])[None],
                             dtype=torch.float32).to(self.device)
        vols = cascaded_ddim_sample(self.model, xr,
                                    torch.Generator(device=self.device).manual_seed(7),
                                    num_steps=t.diffusion_sample_steps)
        gt = torch.as_tensor(np.asarray(item["ct_volume"])[None],
                             dtype=torch.float32).to(self.device)
        for nm, vol in vols.items():
            tgt = resize_target(gt, vol.shape[-3:])
            last[f"chain_{nm}_psnr"] = float(psnr(vol, tgt))
            last[f"chain_{nm}_ssim"] = float(ssim_metric(vol, tgt))
        chain = {k: v for k, v in last.items() if k.startswith("chain_")}
        if not is_main():
            return last
        self.jsonl.log({"phase": "diffusion_chain_eval", **chain})
        if progress:
            print(f"[diffusion] cascaded DDIM eval: "
                  f"{ {k: round(v, 3) for k, v in chain.items()} }")
        return last

    def _restore_state(self, ckpt: CheckpointManager, state: TrainState) -> int:
        """Load ``latest`` into the model (and its optimizer state and step,
        when saved and still fitting the optimizer). Returns the epoch to
        start at: 0 when nothing is saved yet."""
        restored = ckpt.restore_latest()
        if restored is None:
            return 0
        tree, meta = restored
        self.model.load_state_dict(tree["state_dict"])
        opt = ckpt.restore_opt(state.optimizer)
        if opt is not None:
            state.optimizer.load_state_dict(opt["optimizer"])
            state.step = int(opt["step"])
        return int(meta.get("epoch", -1)) + 1

    def _carry_best(self, stage_ckpt: CheckpointManager) -> None:
        """Load a finished stage's best-validation-PSNR weights into the model;
        without a best_psnr entry the final-epoch weights stay."""
        if (stage_ckpt.save_dir / "best_psnr").exists():
            tree, _ = stage_ckpt.restore("best_psnr")
            self.model.load_state_dict(tree["state_dict"])

    def _state_dict_cpu(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().to("cpu", copy=True) for k, v in self.model.state_dict().items()}

    def _run_epochs(self, state: TrainState, train_step, eval_step, batch_size: int,
                    start_epoch: int, epochs: int, lr: float, progress: bool, phase: str,
                    ckpt: CheckpointManager, target_resolution,
                    viz_kwargs: Optional[Dict] = None) -> Dict[str, float]:
        """The epoch loop; ``viz_kwargs`` (the model's keyword arguments for
        the figures) turns on ``_viz_epoch`` under ``training.viz_every``.
        Under data parallelism (the module docstring) every rank runs it:
        the stage's data group trains, an idle rank waits at the barriers."""
        d, t = self.cfg.data, self.cfg.training
        group = data_group(batch_size)
        shard = dict(rank=max(group.index, 0), world=group.size)
        main = is_main()
        progress = progress and main
        tf = (host_target_transform(target_resolution, cache=not d.augmentation)
              if target_resolution else None)
        train_loader = DataLoader(self.train_ds, batch_size, shuffle=True, seed=t.seed,
                                  num_prefetch=d.num_prefetch, transform=tf, **shard)
        val_loader = DataLoader(self.val_ds, batch_size=min(batch_size, max(1, len(self.val_ds))),
                                shuffle=False, drop_last=False, num_prefetch=0, transform=tf,
                                **shard)
        # dropout of step s is drawn from (seed + 1, s), as the JAX trainer
        # folds the step into PRNGKey(seed + 1): a resumed run draws what an
        # uninterrupted one would have; each rank draws for its own samples
        gen = torch.Generator(device=self.device)
        rank_seed = rank() << 40
        activities = [torch.profiler.ProfilerActivity.CPU] + (
            [torch.profiler.ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        metrics: Dict[str, float] = {}
        for epoch in range(start_epoch, epochs):
            train_loader.set_epoch(epoch)
            t0 = time.time()
            row: Dict[str, float] = {}
            if group.active:
                losses = []
                profiling = main and bool(t.profile_dir) and epoch == start_epoch
                with (torch.profiler.profile(activities=activities) if profiling
                      else contextlib.nullcontext()) as prof, use_data_group(group):
                    for i, batch in enumerate(train_loader):
                        batch = to_device(batch, self.device)
                        gen.manual_seed((t.seed + 1) * 1_000_003 + state.step + rank_seed)
                        state, m = train_step(state, batch, gen)
                        if t.debug_nans:
                            _raise_if_not_finite(state, m["total_loss"], phase, epoch, i)
                        losses.append(m["total_loss"].float())
                if profiling:
                    Path(t.profile_dir).mkdir(parents=True, exist_ok=True)
                    prof.export_chrome_trace(
                        str(Path(t.profile_dir) / f"{phase}_epoch{epoch:03d}.json"))
                row["train_loss"] = (float(all_reduce_mean(torch.stack(losses).mean(), group))
                                     if losses else float("nan"))
                vals = [eval_step(to_device(b, self.device),
                                  group if val_loader.sharded(i) else None)
                        for i, b in enumerate(val_loader)]
                if vals:
                    row.update({k: float(torch.stack([v[k].float() for v in vals]).mean())
                                for k in vals[0]})
            if world() > group.size:  # the idle ranks take rank 0's numbers
                row = broadcast_object(row)
            train_loss = row.pop("train_loss")
            val = row
            dt = time.time() - t0
            metrics = {"loss": val.get("loss", train_loss), "psnr": val.get("psnr", 0.0),
                       "ssim": val.get("ssim", 0.0)}
            ckpt.save({"state_dict": self._state_dict_cpu()} if main else {}, epoch, metrics,
                      config=self.cfg.to_dict(),
                      opt={"optimizer": state.optimizer.state_dict(), "step": state.step}
                      if main else None)
            if main:
                self.csv.log(epoch=epoch, phase=phase, loss=f"{train_loss:.6f}",
                             psnr=f"{metrics['psnr']:.3f}", ssim=f"{metrics['ssim']:.4f}",
                             lr=lr, time=f"{dt:.1f}")
                n_samples = len(train_loader) * batch_size
                self.jsonl.log({"epoch": epoch, "phase": phase, "train_loss": train_loss, **val,
                                "seconds": dt, "samples_per_sec": n_samples / max(dt, 1e-9)})
            if t.use_wandb and main:
                from ..utils import wandb_compat

                wandb_compat.log({"phase": phase, "train_loss": train_loss, **val}, step=epoch)
            if progress:
                print(f"[{phase}] epoch {epoch}: loss={train_loss:.4f} "
                      f"val_psnr={metrics['psnr']:.2f} dB val_ssim={metrics['ssim']:.4f} "
                      f"({dt:.1f}s)")
            ve = t.viz_every
            if ve and viz_kwargs is not None and main and (
                    (epoch + 1) % ve == 0 or epoch == epochs - 1):
                try:
                    self._viz_epoch(epoch, phase, viz_kwargs)
                except Exception as exc:  # viz must never kill a training run
                    print(f"[viz] epoch {epoch} visualization failed: {exc}")
        if world() > group.size:  # the idle ranks' weights are a stage behind
            broadcast_module(self.model)
        return metrics

    def _viz_epoch(self, epoch: int, phase: str, model_kwargs: Dict) -> None:
        """Epoch-end figures of one validation item, written to
        ``save_dir/viz/epoch_NNN/``: the prediction against the ground truth
        (every stage's volume for the cascade, by ``return_intermediate``),
        the last 4-D feature map that a module named ``xray_encoder`` puts
        out (forward hooks in place of flax's ``capture_intermediates``) and
        the cross-attention salience of the captured probabilities
        (``capture_attention``: the cascade's stage 1, every block of
        ``direct_vit``). Logs ``{epoch, phase, viz_dir, viz_files}`` to the
        JSONL and the figures to wandb when it is on."""
        from ..models.attention import collect_attention_maps
        from ..models.cascade import ProgressiveCascadeModel
        from ..utils import viz as V
        from ..utils import wandb_compat

        out_dir = Path(self.cfg.checkpoints.save_dir) / "viz" / f"epoch_{epoch:03d}"
        out_dir.mkdir(parents=True, exist_ok=True)
        item = self.val_ds[0]
        xrays = torch.as_tensor(np.asarray(item["drr_stacked"])[None],
                                dtype=torch.float32).to(self.device)
        gt = np.asarray(item["ct_volume"], np.float32)
        mkw = dict(model_kwargs)
        if isinstance(self.model, ProgressiveCascadeModel):
            mkw["return_intermediate"] = True  # all stage volumes
        feats = []

        def keep_maps(module, args, out):
            outs = out if isinstance(out, (tuple, list)) else (out,)
            feats.extend(o for o in outs if isinstance(o, torch.Tensor) and o.dim() == 4)

        hooks = [m.register_forward_hook(keep_maps) for name, m in self.model.named_modules()
                 if "xray_encoder" in name.rsplit(".", 1)[-1]]
        capture = (self.model.capture_attention() if hasattr(self.model, "capture_attention")
                   else contextlib.nullcontext())
        try:
            with torch.no_grad(), capture:
                pred = self.model(xrays, train=False, **mkw)
                att = collect_attention_maps(self.model)
        finally:
            for h in hooks:
                h.remove()

        files: Dict[str, str] = {}
        vols = pred if isinstance(pred, dict) else {phase: pred}
        vols = {k: v.float().cpu().numpy() for k, v in vols.items()}
        p = str(out_dir / f"{phase}_prediction_vs_gt.png")
        V.compare_stage_outputs(vols, gt, p)
        files[f"viz/{phase}/prediction_vs_gt"] = p
        if feats:
            p = str(out_dir / f"{phase}_xray_features.png")
            V.plot_feature_maps(feats[-1].float().cpu().numpy(), p,
                                title=f"X-ray encoder features — {phase} epoch {epoch}")
            files[f"viz/{phase}/xray_features"] = p
        if att:
            p = str(out_dir / f"{phase}_attention_salience.png")
            V.plot_attention_salience(att["cross_attention"].float().cpu().numpy(), p,
                                      title=f"Cross-attention salience — {phase} epoch {epoch}")
            files[f"viz/{phase}/attention_salience"] = p
        self.jsonl.log({"epoch": epoch, "phase": phase, "viz_dir": str(out_dir),
                        "viz_files": sorted(Path(f).name for f in files.values())})
        if self.cfg.training.use_wandb:
            wandb_compat.log_images(files, step=epoch)


def _raise_if_not_finite(state: TrainState, loss: torch.Tensor, phase: str, epoch: int,
                         step: int) -> None:
    """``training.debug_nans``: FloatingPointError when the step's loss or a
    gradient it left on the optimizer's parameters is not finite; one host
    sync."""
    grads = [p.grad for g in state.optimizer.param_groups for p in g["params"]
             if p.grad is not None]
    finite = torch.stack([torch.isfinite(loss).all(), *(torch.isfinite(g).all() for g in grads)])
    if not bool(finite.all()):
        what = "loss" if not bool(finite[0]) else "gradient"
        raise FloatingPointError(f"debug_nans: non-finite {what} in phase {phase}, epoch "
                                 f"{epoch}, step {step} of the epoch (optimizer step "
                                 f"{state.step})")
