"""The typed configuration, standard library only (counterpart of
hybrid_vit_cascade_tpu/config.py).

The same dataclass tree, defaults and JSON round-trip as the JAX package's
``Config``, so one JSON file or checkpoint ``config`` dict loads into either
package; the port imports this one and never the JAX package. Field comments
are in the JAX module. ``validate_config`` and ``data_volume_size`` are the
JAX module's too.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional, Tuple

MODEL_FAMILIES = ("direct_vit", "cascade", "direct128_h200", "direct256_h200",
                  "direct256_b200", "diffusion")


@dataclass
class ModelConfig:
    family: str = "direct_vit"
    volume_size: Tuple[int, int, int] = (64, 64, 64)
    xray_img_size: int = 512
    voxel_dim: int = 256
    vit_depth: int = 4
    num_heads: int = 4
    xray_feature_dim: int = 512
    stage_depths: Tuple[int, int, int] = (4, 6, 8)
    stage_heads: Tuple[int, int, int] = (4, 8, 8)
    stage_sizes: Tuple[int, int, int] = (64, 128, 256)
    use_gradient_checkpointing: bool = True
    dtype: str = "float32"  # compute dtype: "float32" | "bfloat16"
    attn_impl: str = "auto"
    stage3_slab_scan: bool = False
    slab_count: int = 8
    slab_impl: str = "streamed"
    remat_mode: str = "block"  # 'block' | 'mlp'
    diffusion_lift_slabs: int = 0


@dataclass
class StageConfig:
    num_epochs: int = 50
    batch_size: int = 8
    learning_rate: float = 1e-4
    target_resolution: Tuple[int, int, int] = (64, 64, 64)


@dataclass
class TrainingConfig:
    weight_decay: float = 0.01
    gradient_clip: float = 1.0
    seed: int = 0
    diffusion_sample_steps: int = 20
    diffusion_progressive: bool = False
    freeze_shared_diffusion: bool = False
    freeze_shared_encoder_stage3: bool = False
    stage3_split_step: bool = False
    num_epochs: int = 100
    batch_size: int = 8
    learning_rate: float = 1e-4
    warmup_steps: int = 0
    profile_dir: str = ""
    debug_nans: bool = False
    use_wandb: bool = False
    viz_every: int = 0
    stages: Dict[str, StageConfig] = field(
        default_factory=lambda: {
            "stage1": StageConfig(50, 8, 1e-4, (64, 64, 64)),
            "stage2": StageConfig(30, 2, 5e-5, (128, 128, 128)),
            "stage3": StageConfig(20, 2, 2e-5, (256, 256, 256)),
        }
    )


@dataclass
class LossConfig:
    stage1: Dict[str, float] = field(default_factory=lambda: {"l1": 1.0, "ssim": 0.5})
    stage2: Dict[str, float] = field(
        default_factory=lambda: {"l1": 1.0, "ssim": 0.5, "vgg": 0.1, "tv": 0.02, "freq": 0.05}
    )
    stage3: Dict[str, float] = field(
        default_factory=lambda: {"l1": 1.0, "ssim": 0.5, "vgg": 0.1, "tv": 0.03, "freq": 0.07, "drr": 0.3}
    )
    vgg_weights: Optional[str] = None  # .npz of VGG16 filters; None: seeded filters


@dataclass
class DataConfig:
    dataset_path: str = ""
    synthetic: bool = False
    synthetic_patients: int = 16
    max_patients: Optional[int] = None
    train_split: float = 0.8
    val_split: float = 0.1
    split_mode: str = "seeded_random"
    normalization: str = "soft_tissue"
    xray_size: int = 512
    augmentation: bool = False
    cache_in_memory: bool = False
    num_prefetch: int = 2


@dataclass
class CheckpointConfig:
    save_dir: str = "checkpoints"
    save_every: int = 10
    keep_best: Tuple[str, ...] = ("loss", "psnr", "ssim")


@dataclass
class ParallelConfig:
    data_axis: int = -1
    mesh_axes: Tuple[str, ...] = ("data",)


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    data: DataConfig = field(default_factory=DataConfig)
    checkpoints: CheckpointConfig = field(default_factory=CheckpointConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, path: str) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2, default=list))

    @staticmethod
    def from_dict(d: dict) -> "Config":
        def build(cls, src: dict):
            kwargs = {}
            for f in dataclasses.fields(cls):
                if f.name not in src:
                    continue
                v = src[f.name]
                if isinstance(v, list) and isinstance(getattr(cls(), f.name, None), tuple):
                    v = tuple(v)  # JSON has no tuples
                kwargs[f.name] = v
            return cls(**kwargs)

        cfg = Config(
            model=build(ModelConfig, d.get("model", {})),
            training=_build_training(d.get("training", {})),
            loss=build(LossConfig, d.get("loss", {})),
            data=build(DataConfig, d.get("data", {})),
            checkpoints=build(CheckpointConfig, d.get("checkpoints", {})),
            parallel=build(ParallelConfig, d.get("parallel", {})),
        )
        # reference-style flat fields
        if "model_name" in d and "progressive" in str(d.get("model_name", "")):
            cfg.model.family = "cascade"
        return cfg

    @staticmethod
    def from_json(path: str) -> "Config":
        return Config.from_dict(json.loads(Path(path).read_text()))


def _stage(sv: dict) -> StageConfig:
    return StageConfig(
        num_epochs=sv.get("num_epochs", 50),
        batch_size=sv.get("batch_size", 8),
        learning_rate=sv.get("learning_rate", 1e-4),
        target_resolution=tuple(sv.get("target_resolution", (64, 64, 64))),
    )


def _build_training(src: dict) -> TrainingConfig:
    t = TrainingConfig()
    for f in dataclasses.fields(TrainingConfig):
        if f.name in src and f.name != "stages":
            setattr(t, f.name, src[f.name])
    stages = {name: _stage(sv) for name, sv in src.get("stages", {}).items()}
    # the reference's config_progressive.json puts stage blocks directly in "training"
    for name in ("stage1", "stage2", "stage3"):
        if name in src and isinstance(src[name], dict):
            stages[name] = _stage(src[name])
    if stages:
        t.stages = stages
    return t


# the values of model.attn_impl, as the JAX dispatcher reads them
# (ops/attention.py:144); ops/attention.py dispatches on them
ATTN_IMPLS = ("auto", "flash", "flash_sharded", "xla")


def validate_config(cfg: Config) -> None:
    """Schema and consistency checks (the JAX ``validate_config``)."""
    if cfg.model.family not in MODEL_FAMILIES:
        raise ValueError(f"unknown model family {cfg.model.family!r}; expected one of "
                         f"{MODEL_FAMILIES}")
    if cfg.model.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"dtype must be float32|bfloat16, got {cfg.model.dtype}")
    if cfg.model.slab_impl not in ("streamed", "recompute"):
        raise ValueError(f"slab_impl must be streamed|recompute, got {cfg.model.slab_impl}")
    if cfg.model.remat_mode not in ("block", "mlp"):
        raise ValueError(f"remat_mode must be block|mlp, got {cfg.model.remat_mode}")
    if cfg.model.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {'|'.join(ATTN_IMPLS)}, got "
                         f"{cfg.model.attn_impl!r}")
    if cfg.model.family == "cascade":
        for name in ("stage1", "stage2", "stage3"):
            if name not in cfg.training.stages:
                raise ValueError(f"cascade training requires stages stage1..3; missing {name}")
    if not cfg.data.synthetic and not cfg.data.dataset_path:
        raise ValueError("data.dataset_path required unless data.synthetic=true")


def data_volume_size(cfg: Config) -> Tuple[int, int, int]:
    """The dataset's target volume size: the top resolution any part of the
    model trains or evaluates against (the cascade's last stage size)."""
    m = cfg.model
    if m.family == "cascade":
        top = max(m.stage_sizes)
        return (top, top, top)
    if m.family.startswith("direct128"):
        return (128, 128, 128)
    if m.family.startswith("direct256"):
        return (256, 256, 256)
    return tuple(m.volume_size)
