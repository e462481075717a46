"""Checkpoint-driven cascade inference (counterpart of
hybrid_vit_cascade_tpu/inference/infer.py:27-33, 111-160, and of the cascade
branch of ``build_model`` in hybrid_vit_cascade_tpu/training/trainer.py).

A checkpoint is one ``torch.save`` file holding
``{"config": Config.to_dict(), "state_dict": model.state_dict()}`` — the
port's counterpart of an Orbax directory plus its ``meta.json``.
Evaluation, NIfTI/PNG export and the raw X-ray-pair loader are not ported
yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from hybrid_vit_cascade_tpu.config import Config

from ..models.cascade import ProgressiveCascadeModel

_STAGE_PREFIXES = {1: ("xray_encoder.", "stage2.", "stage3."), 2: ("stage3.",), 3: ()}


def denormalize_ct(volume: np.ndarray, normalization: str = "soft_tissue") -> np.ndarray:
    """normalized volume → HU (inverse of the dataset presets)."""
    if normalization == "soft_tissue":  # [-1,1] → [-200,200]
        return volume * 200.0
    if normalization == "full":  # [0,1] → [-1024,3071]
        return volume * 4095.0 - 1024.0
    raise ValueError(normalization)


def build_model(cfg: Config, built_stages: int = 3) -> ProgressiveCascadeModel:
    """The model a config names: fp32 parameters, compute in cfg.model.dtype.
    Only the cascade family is ported so far."""
    m = cfg.model
    if m.family != "cascade":
        raise NotImplementedError(f"model family {m.family!r} is not ported yet (cascade only)")
    dtype = torch.bfloat16 if m.dtype == "bfloat16" else torch.float32
    return ProgressiveCascadeModel(
        xray_feature_dim=m.xray_feature_dim, voxel_dim=m.voxel_dim,
        stage_depths=tuple(m.stage_depths), stage_heads=tuple(m.stage_heads),
        stage_sizes=tuple(m.stage_sizes), dtype=dtype, built_stages=built_stages)


def save_checkpoint(path: str | Path, cfg: Config, model: torch.nn.Module) -> None:
    """Write a checkpoint that InferenceEngine loads."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"config": cfg.to_dict(), "state_dict": state}, str(path))


class InferenceEngine:
    """Load a checkpoint (+ embedded config) and reconstruct volumes.

    max_stage: the deepest stage to build and load — pass 2 to load a
    stage-pruned checkpoint (or to skip stage 3's weights) and serve stages
    ≤ 2."""

    def __init__(self, checkpoint_path: str | Path, config: Optional[Config] = None,
                 device: str | torch.device = "cuda", max_stage: int = 3):
        ckpt = torch.load(str(checkpoint_path), map_location="cpu", weights_only=True)
        self.cfg = config if config is not None else Config.from_dict(ckpt["config"])
        self.device = torch.device(device)
        self.max_stage = max_stage
        model = build_model(self.cfg, built_stages=max_stage)
        state = dict(ckpt["state_dict"])
        extra = [k for k in state if k not in model.state_dict()]
        pruned = _STAGE_PREFIXES[max_stage]
        bad = [k for k in extra if not k.startswith(pruned)]
        if bad:
            raise KeyError(f"checkpoint keys the model does not have: {bad[:5]}")
        for k in extra:
            del state[k]
        model.load_state_dict(state, strict=True)
        self.model = model.to(self.device).eval()

    def reconstruct(self, xrays, max_stage: Optional[int] = None,
                    return_intermediate: bool = False):
        """xrays (B, 2, 1, S, S) → (B, 1, D, H, W) on the engine's device in
        the model's compute dtype, or a {"stage1": ..., ...} dict."""
        x = torch.as_tensor(xrays, dtype=torch.float32).to(self.device)
        with torch.inference_mode():
            return self.model(x, return_intermediate=return_intermediate,
                              max_stage=self.max_stage if max_stage is None else max_stage)
