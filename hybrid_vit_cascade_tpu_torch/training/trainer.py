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
``Direct256Loss`` for the decoders). The diffusion family is not ported.
Not ported either: the epoch-end
visualization (``_viz_epoch``: the run prints that it is skipped and goes
on, as the JAX trainer does when visualization fails), wandb logging,
profiler traces and NaN debugging (``use_wandb``, ``profile_dir`` and
``debug_nans`` raise), the multi-device mesh (one card).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
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
from ..losses.metrics import psnr, ssim_metric
from ..losses.multiscale import MultiScaleLoss, l1_loss
from ..ops.resize import resize_trilinear, resize_trilinear_np
from ..utils.logging import CSVLogger, JSONLLogger
from .checkpoint import CheckpointManager
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
    ``direct_vit``, ``Direct256Loss()`` for the CNN decoders. Returns
    (state, step)."""
    t = cfg.training
    opt = make_optimizer(model.parameters(), learning_rate, total_steps, t.weight_decay,
                         t.gradient_clip, t.warmup_steps)
    if cfg.model.family == "direct_vit":
        loss_obj = MultiScaleLoss({"stage1": cfg.loss.stage1}, vgg_weights=cfg.loss.vgg_weights)
        loss_fn = lambda pred, batch: loss_obj(pred, batch["ct_volume"], stage=1)  # noqa: E731
    else:
        d256 = Direct256Loss()
        loss_fn = lambda pred, batch: d256(pred, batch["ct_volume"])  # noqa: E731
    return TrainState(model, opt), make_train_step(model, loss_fn, train=train)


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
    asks for the CPU). The cascade's stage N writes its checkpoints to
    ``save_dir/stageN``, a single-model family to ``save_dir`` (``ckpt``);
    the CSV and JSONL logs go to ``save_dir/training_log.{csv,jsonl}``."""

    def __init__(self, cfg: Config, device: str | torch.device = "cuda"):
        validate_config(cfg)
        t = cfg.training
        for flag in ("use_wandb", "profile_dir", "debug_nans"):
            if getattr(t, flag):
                raise NotImplementedError(f"training.{flag} is not ported")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device; pass device='cpu' to train on the CPU")
        self.cfg = cfg
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(t.seed)
            self.model = build_model(cfg).to(self.device)
        save_dir = cfg.checkpoints.save_dir
        self.ckpt = CheckpointManager(save_dir, cfg.checkpoints.save_every,
                                      cfg.checkpoints.keep_best)
        self.csv = CSVLogger(f"{save_dir}/training_log.csv")
        self.jsonl = JSONLLogger(f"{save_dir}/training_log.jsonl")
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
        t = self.cfg.training
        epochs = epochs if epochs is not None else t.num_epochs
        lr = lr_override if lr_override is not None else t.learning_rate
        steps_per_epoch = max(1, len(self.train_ds) // t.batch_size)
        state, train_step = single_model_step(self.model, self.cfg, steps_per_epoch * epochs, lr)
        start_epoch = self._restore_state(self.ckpt, state) if resume else 0
        eval_step = make_eval_step(self.model, lambda b: b["ct_volume"])
        return self._run_epochs(state, train_step, eval_step, t.batch_size, start_epoch, epochs,
                                lr, progress, "train", self.ckpt, None)

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
                if progress:
                    print(f"[{stage_name}] complete at epoch {start_epoch - 1}; skipping")
                continue
            resolution = tuple(sc.target_resolution)
            eval_step = make_eval_step(
                self.model, lambda b, _res=resolution: resize_target(b["ct_volume"], _res),
                {"max_stage": n})
            last = self._run_epochs(state, train_step, eval_step, sc.batch_size, start_epoch,
                                    sc.num_epochs, sc.learning_rate, progress, stage_name,
                                    stage_ckpt, resolution)
            self._carry_best(stage_ckpt)
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
                    ckpt: CheckpointManager, target_resolution) -> Dict[str, float]:
        d, t = self.cfg.data, self.cfg.training
        tf = (host_target_transform(target_resolution, cache=not d.augmentation)
              if target_resolution else None)
        train_loader = DataLoader(self.train_ds, batch_size, shuffle=True, seed=t.seed,
                                  num_prefetch=d.num_prefetch, transform=tf)
        val_loader = DataLoader(self.val_ds, batch_size=min(batch_size, max(1, len(self.val_ds))),
                                shuffle=False, drop_last=False, num_prefetch=0, transform=tf)
        # dropout of step s is drawn from (seed + 1, s), as the JAX trainer
        # folds the step into PRNGKey(seed + 1): a resumed run draws what an
        # uninterrupted one would have
        gen = torch.Generator(device=self.device)
        metrics: Dict[str, float] = {}
        for epoch in range(start_epoch, epochs):
            train_loader.set_epoch(epoch)
            t0 = time.time()
            losses, n_samples = [], 0
            for batch in train_loader:
                batch = to_device(batch, self.device)
                gen.manual_seed((t.seed + 1) * 1_000_003 + state.step)
                state, m = train_step(state, batch, gen)
                losses.append(m["total_loss"].float())
                n_samples += batch["drr_stacked"].shape[0]
            train_loss = float(torch.stack(losses).mean()) if losses else float("nan")
            vals = [eval_step(to_device(b, self.device)) for b in val_loader]
            val = ({k: float(torch.stack([v[k].float() for v in vals]).mean()) for k in vals[0]}
                   if vals else {})
            dt = time.time() - t0
            metrics = {"loss": val.get("loss", train_loss), "psnr": val.get("psnr", 0.0),
                       "ssim": val.get("ssim", 0.0)}
            ckpt.save({"state_dict": self._state_dict_cpu()}, epoch, metrics,
                      config=self.cfg.to_dict(),
                      opt={"optimizer": state.optimizer.state_dict(), "step": state.step})
            self.csv.log(epoch=epoch, phase=phase, loss=f"{train_loss:.6f}",
                         psnr=f"{metrics['psnr']:.3f}", ssim=f"{metrics['ssim']:.4f}",
                         lr=lr, time=f"{dt:.1f}")
            self.jsonl.log({"epoch": epoch, "phase": phase, "train_loss": train_loss, **val,
                            "seconds": dt, "samples_per_sec": n_samples / max(dt, 1e-9)})
            if progress:
                print(f"[{phase}] epoch {epoch}: loss={train_loss:.4f} "
                      f"val_psnr={metrics['psnr']:.2f} dB val_ssim={metrics['ssim']:.4f} "
                      f"({dt:.1f}s)")
            ve = t.viz_every
            if ve and ((epoch + 1) % ve == 0 or epoch == epochs - 1):
                print(f"[viz] epoch {epoch}: epoch-end visualization is not ported; skipped")
        return metrics
