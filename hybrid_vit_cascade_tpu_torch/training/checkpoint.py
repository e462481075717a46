"""Checkpoints with the reference's patterns (counterpart of
hybrid_vit_cascade_tpu/training/checkpoint.py, where Orbax writes them):

  (a) triple best checkpoints by loss / PSNR / SSIM
  (b) periodic epoch checkpoints
  (c) filtered restore by key prefix and shape-matched transfer
  (d) resume with the optimizer state beside the model
  (e) the config embedded in every entry's meta.json

Layout, as in the JAX package: ``save_dir/{latest, latest_opt, best_loss,
best_psnr, best_ssim, epoch_%04d}/`` and ``save_dir/best_records.json``. Each
entry is a directory holding one ``torch.save`` file (``checkpoint.pt``) and
``meta.json`` ({"epoch", "metrics", "config"}); it is written under
``<name>.tmp`` and renamed into place, so a reader sees a whole entry or the
previous one. Model entries hold ``{"state_dict": ...}``, ``latest_opt``
holds ``{"optimizer": Optimizer.state_dict(), "step": int}``. Under data
parallelism every rank calls ``save`` and keeps the same ``best``, rank 0
alone writes, and the others wait at a barrier until every entry is renamed
into place (the JAX manager's process-0 writes between barriers); restore
runs on every rank.
"""

from __future__ import annotations

import json
import math
import pickle
import shutil
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from ..parallel.mesh import barrier, is_main

CKPT_FILE = "checkpoint.pt"


class CheckpointManager:
    """Writes and reads the entries of one directory (one training stage).
    ``best`` holds the best value of each tracked metric so far."""

    def __init__(self, save_dir: str, save_every: int = 10,
                 keep_best: Sequence[str] = ("loss", "psnr", "ssim")):
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.save_every = save_every
        self.keep_best = tuple(keep_best)
        self.best: Dict[str, float] = {}
        f = self.save_dir / "best_records.json"
        if f.exists():
            self.best = json.loads(f.read_text())

    def _write(self, name: str, tree: Dict, meta: Dict[str, Any]) -> None:
        write_entry(self.save_dir / name, tree, meta)

    def save(self, tree: Dict, epoch: int, metrics: Dict[str, float],
             config: Optional[dict] = None, opt: Optional[Dict] = None) -> Dict[str, bool]:
        """Save 'latest' (+ 'latest_opt' when ``opt`` is given, + the periodic
        entry) and update the best-by-metric entries. metrics: {'loss':
        val_loss, 'psnr': ..., 'ssim': ...}; loss is best when lowest, the
        others when highest. Returns which best tags improved. Every rank
        calls it with the same metrics; only rank 0's ``tree`` and ``opt``
        are read."""
        main = is_main()
        meta = {"epoch": epoch, "metrics": metrics, "config": config or {}}
        if main:
            self._write("latest", tree, meta)
            if opt is not None:
                self._write("latest_opt", opt, meta)
            if self.save_every and (epoch + 1) % self.save_every == 0:
                self._write(f"epoch_{epoch:04d}", tree, meta)
        improved = {}
        for tag in self.keep_best:
            if tag not in metrics:
                continue
            val = float(metrics[tag])
            if tag == "loss":
                better = val < self.best.get(tag, math.inf)
            else:
                better = val > self.best.get(tag, -math.inf)
            if better:
                self.best[tag] = val
                if main:
                    self._write(f"best_{tag}", tree, meta)
                improved[tag] = True
        if main:
            (self.save_dir / "best_records.json").write_text(json.dumps(self.best, indent=2))
        barrier()
        return improved

    # --- restore ----------------------------------------------------------
    def restore(self, name_or_path: str) -> Tuple[Dict, Dict]:
        """(tree, meta) of an entry, by name in this directory or by path;
        tensors on the CPU."""
        path = Path(name_or_path)
        if not path.exists():
            path = self.save_dir / name_or_path
        return load_entry(path)

    def restore_latest(self) -> Optional[Tuple[Dict, Dict]]:
        if not (self.save_dir / "latest").exists():
            return None
        return self.restore("latest")

    def restore_opt(self, optimizer: torch.optim.Optimizer) -> Optional[Dict]:
        """The 'latest_opt' entry ({"optimizer", "step"}) if it fits
        ``optimizer`` (same parameter groups, same parameter counts, moments
        of the parameters' shapes); None when it is absent or does not fit,
        e.g. after the stage's trainable set changed. Resume then proceeds with
        a fresh optimizer state, as in the JAX package. ``optimizer`` is not
        changed."""
        if not (self.save_dir / "latest_opt").exists():
            return None
        try:
            tree, _ = self.restore("latest_opt")
        except (OSError, RuntimeError, pickle.UnpicklingError):
            return None
        if not isinstance(tree, dict) or "step" not in tree \
                or not _fits(tree.get("optimizer"), optimizer):
            return None
        return tree


def write_entry(path: str | Path, tree: Dict, meta: Dict[str, Any]) -> None:
    """Write one checkpoint entry directory: ``checkpoint.pt`` (``tree``) and
    ``meta.json``, under ``<path>.tmp`` renamed into place over any previous
    entry, so a reader sees a whole entry or the previous one. Makes the
    entry's directory as needed."""
    path = Path(path).absolute()
    tmp = path.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    torch.save(tree, tmp / CKPT_FILE)
    (tmp / "meta.json").write_text(json.dumps(meta, indent=2, default=float))
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)


def load_entry(path: str | Path) -> Tuple[Dict, Dict]:
    """(tree, meta) of one checkpoint entry directory; tensors on the CPU."""
    path = Path(path)
    tree = torch.load(path / CKPT_FILE, map_location="cpu", weights_only=True)
    mf = path / "meta.json"
    meta = json.loads(mf.read_text()) if mf.exists() else {}
    return tree, meta


DEVICE_FLAGS = ("fused", "foreach", "capturable", "differentiable")


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: Mapping) -> None:
    """``optimizer.load_state_dict(state)``, keeping the live optimizer's
    implementation flags (``DEVICE_FLAGS``): ``load_state_dict`` takes every
    group setting from the file, so a state written on the CPU (``fused``
    False) would turn the card's fused AdamW into the per-tensor loop. Every
    other setting, the moments and the counts come from ``state``."""
    groups = []
    for saved, live in zip(state["param_groups"], optimizer.param_groups):
        groups.append({**saved, **{k: live[k] for k in DEVICE_FLAGS if k in live}})
    optimizer.load_state_dict({**state, "param_groups": groups})


def _fits(state: Any, optimizer: torch.optim.Optimizer) -> bool:
    """Whether an Optimizer.state_dict() can be loaded into ``optimizer`` and
    stepped: group by group the same number of parameters, and each saved
    per-parameter tensor (beyond scalars such as Adam's step) of its
    parameter's shape."""
    if not isinstance(state, dict) or not isinstance(state.get("param_groups"), list):
        return False
    groups = optimizer.param_groups
    if len(state["param_groups"]) != len(groups):
        return False
    params = {}
    for saved, group in zip(state["param_groups"], groups):
        if len(saved.get("params", ())) != len(group["params"]):
            return False
        params.update(zip(saved["params"], group["params"]))
    for pid, entry in state.get("state", {}).items():
        p = params.get(pid)
        if p is None:
            return False
        for t in entry.values():
            if isinstance(t, torch.Tensor) and t.dim() > 0 and t.shape != p.shape:
                return False
    return True


def filtered_restore(params: Mapping[str, torch.Tensor], loaded: Mapping[str, torch.Tensor],
                     include_prefixes: Sequence[str]) -> Dict[str, torch.Tensor]:
    """Take from ``loaded`` only the entries whose top-level module name
    starts with a prefix — the reference's key-prefix filtered load — on
    state dicts."""
    out = dict(params)
    for key in params:
        if any(key.split(".", 1)[0].startswith(p) for p in include_prefixes) and key in loaded:
            out[key] = loaded[key]
    return out


def shape_matched_transfer(params: Mapping[str, torch.Tensor],
                           loaded: Mapping[str, torch.Tensor]
                           ) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """Copy every entry whose name exists in both state dicts with the same
    shape, cast to the target's dtype (cross-architecture transfer). Returns
    (new state dict, transferred, skipped)."""
    out, transferred, skipped = {}, 0, 0
    for key, leaf in params.items():
        cand = loaded.get(key)
        if cand is not None and tuple(cand.shape) == tuple(leaf.shape):
            out[key] = torch.as_tensor(cand).to(leaf.dtype)
            transferred += 1
        else:
            out[key] = leaf
            skipped += 1
    return out, transferred, skipped
