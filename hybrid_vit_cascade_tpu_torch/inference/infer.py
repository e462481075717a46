"""Checkpoint-driven inference and its exports (counterpart of
hybrid_vit_cascade_tpu/inference/infer.py and of ``build_model`` in
hybrid_vit_cascade_tpu/training/trainer.py): reconstruct, per-stage (the
cascade) or whole-volume (the other families) metrics and whole-dataset
summaries, the diagnostic suite with live cross-attention capture (the
families with attention), ``.npy`` / NIfTI / PNG export with optional
trilinear upscale and HU denormalisation, the raw X-ray-pair loader and the
checkpoint inspector.

A checkpoint is one ``torch.save`` file holding
``{"config": Config.to_dict(), "state_dict": model.state_dict()}``, or an
entry directory that training wrote (``training/checkpoint.py``, e.g.
``save_dir/stage3/best_psnr``: the state dict in ``checkpoint.pt``, the
config in ``meta.json``) — the port's counterparts of an Orbax directory
plus its ``meta.json``.

The PNG writers need matplotlib: without it ``export`` prints a message and
leaves their keys out of the paths it returns. Not ported: ``export_serving``
and ``load_serving`` (a StableHLO artifact; the kernels are not registered
with ``torch.library``, so ``torch.export`` cannot trace them yet), and the
diffusion family, which ``build_model`` refuses.
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..losses.metrics import mae, psnr, psnr_dynamic_range, ssim_metric
from ..models import cnn_models
from ..models.cascade import ProgressiveCascadeModel
from ..models.direct import DirectCTRegression
from ..ops.resize import resize_trilinear
from ..training.checkpoint import load_entry

_STAGE_PREFIXES = {1: ("xray_encoder.", "stage2.", "stage3."), 2: ("stage3.",), 3: ()}
# the model families build_model builds (all but diffusion)
PORTED_FAMILIES = ("cascade", "direct_vit", "direct128_h200", "direct256_h200", "direct256_b200")


def denormalize_ct(volume: np.ndarray, normalization: str = "soft_tissue") -> np.ndarray:
    """normalized volume → HU (inverse of the dataset presets)."""
    if normalization == "soft_tissue":  # [-1,1] → [-200,200]
        return volume * 200.0
    if normalization == "full":  # [0,1] → [-1024,3071]
        return volume * 4095.0 - 1024.0
    raise ValueError(normalization)


def load_xray_pair(pa_path: str, lat_path: str, size: int = 512,
                   normalize_range: Tuple[float, float] = (0.0, 1.0)) -> np.ndarray:
    """A raw AP / lateral X-ray image pair straight from image files (no
    dataset folder): grey levels, bilinear resize to size², /255 when above 1,
    then into normalize_range → (1, 2, 1, size, size) fp32. Needs PIL."""
    from PIL import Image

    from ..data.dataset import _np_resize_bilinear

    views = []
    for p in (pa_path, lat_path):
        img = np.asarray(Image.open(p).convert("L"), dtype=np.float32)
        if img.shape != (size, size):
            img = _np_resize_bilinear(img, (size, size))
        if img.max() > 1.0:
            img = img / 255.0
        lo, hi = normalize_range
        views.append(img * (hi - lo) + lo)
    return np.stack(views)[None, :, None].astype(np.float32)


def export_nifti(volume: np.ndarray, path: str,
                 spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)) -> None:
    """(D, H, W) → .nii.gz (fp32, diagonal affine) with the port's NIfTI-1
    writer."""
    from ..data.nifti import write_nifti

    write_nifti(path, np.asarray(volume, np.float32), spacing)


def export_orthogonal_views(volume: np.ndarray, out_prefix: str, title: str = "") -> None:
    """Axial / coronal / sagittal mid-slice PNGs (matplotlib Agg)."""
    from ..utils.viz import _plt

    plt = _plt()
    D, H, W = volume.shape
    views = {"axial": volume[D // 2], "coronal": volume[:, H // 2],
             "sagittal": volume[:, :, W // 2]}
    for name, sl in views.items():
        fig, ax = plt.subplots(figsize=(5, 5))
        ax.imshow(sl, cmap="gray")
        ax.set_title(f"{title} {name}".strip())
        ax.axis("off")
        fig.savefig(f"{out_prefix}_{name}.png", dpi=120, bbox_inches="tight")
        plt.close(fig)


def save_npy(path: str | Path, volume: torch.Tensor | np.ndarray) -> None:
    """``np.save`` of a volume; a bf16 tensor is written as the JAX package's
    ``np.save`` writes an ml_dtypes bfloat16 array: its raw 2-byte values
    under the descr ``'<V2'``."""
    if isinstance(volume, torch.Tensor) and volume.dtype == torch.bfloat16:
        bits = volume.detach().cpu().contiguous().view(torch.int16).numpy()
        header = {"descr": "<V2", "fortran_order": False, "shape": bits.shape}
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(f, header)
            f.write(bits.tobytes())
        return
    if isinstance(volume, torch.Tensor):
        volume = volume.detach().cpu().numpy()
    np.save(path, volume)


def inspect_checkpoint(ckpt_path: str | Path) -> Dict:
    """The names and shapes (``str(tuple(shape))``) of a checkpoint's state
    dict, with the entry's ``meta.json`` when there is one (a checkpoint file's
    own config otherwise); ``"error"`` holds what failed to load."""
    path = Path(ckpt_path)
    meta = {}
    mf = path / "meta.json"
    if mf.exists():
        meta = json.loads(mf.read_text())
    report = {"path": str(path), "meta": meta, "arrays": {}}
    try:
        cfg, state = load_checkpoint(path)
        if not path.is_dir():
            report["meta"] = {"config": cfg}
        report["arrays"] = {k: str(tuple(v.shape)) for k, v in state.items()}
    except Exception as e:
        report["error"] = repr(e)
    return report


def build_model(cfg: Config, built_stages: int = 3) -> torch.nn.Module:
    """The model a config names: fp32 parameters, compute in cfg.model.dtype
    (JAX ``trainer.py:63-95``). ``built_stages`` applies to the cascade. The
    CNN decoders take the config's ``use_gradient_checkpointing`` as
    ``remat``; ``DirectCTRegression`` takes no remat, as in JAX. The diffusion family is
    not ported."""
    m = cfg.model
    if m.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"model family {m.family!r} is not ported yet")
    dtype = torch.bfloat16 if m.dtype == "bfloat16" else torch.float32
    if m.family == "cascade":
        return ProgressiveCascadeModel(
            xray_feature_dim=m.xray_feature_dim, voxel_dim=m.voxel_dim,
            stage_depths=tuple(m.stage_depths), stage_heads=tuple(m.stage_heads),
            stage_sizes=tuple(m.stage_sizes), dtype=dtype, built_stages=built_stages,
            use_gradient_checkpointing=m.use_gradient_checkpointing, remat_mode=m.remat_mode,
            stage3_slab_scan=m.stage3_slab_scan, slab_count=m.slab_count, slab_impl=m.slab_impl)
    if m.family == "direct_vit":
        return DirectCTRegression(tuple(m.volume_size), m.voxel_dim, m.vit_depth, m.num_heads,
                                  m.xray_feature_dim, dtype)
    remat = m.use_gradient_checkpointing
    if m.family == "direct128_h200":
        return cnn_models.Direct128ModelH200(m.xray_feature_dim, dtype=dtype, remat=remat)
    if m.family == "direct256_h200":
        return cnn_models.Direct256ModelH200(m.xray_feature_dim, dtype=dtype, remat=remat)
    return cnn_models.Direct256ModelB200(dtype=dtype, remat=remat)


def save_checkpoint(path: str | Path, cfg: Config, model: torch.nn.Module) -> None:
    """Write a checkpoint that InferenceEngine loads."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"config": cfg.to_dict(), "state_dict": state}, str(path))


def load_checkpoint(path: str | Path) -> tuple[dict, dict]:
    """(config dict, state dict) of a checkpoint file or entry directory."""
    path = Path(path)
    if path.is_dir():
        tree, meta = load_entry(path)
        return meta.get("config", {}), tree["state_dict"]
    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    return ckpt["config"], ckpt["state_dict"]


class InferenceEngine:
    """Load a checkpoint (+ embedded config) and reconstruct volumes.

    max_stage (the cascade): the deepest stage to build and load — pass 2 to
    load a stage-pruned checkpoint (or to skip stage 3's weights) and serve
    stages ≤ 2."""

    def __init__(self, checkpoint_path: str | Path, config: Optional[Config] = None,
                 device: str | torch.device = "cuda", max_stage: int = 3):
        cfg_dict, state = load_checkpoint(checkpoint_path)
        self.cfg = config if config is not None else Config.from_dict(cfg_dict)
        self.device = torch.device(device)
        self.max_stage = max_stage
        model = build_model(self.cfg, built_stages=max_stage)
        state = dict(state)
        extra = [k for k in state if k not in model.state_dict()]
        pruned = _STAGE_PREFIXES[max_stage] if self.cascade else ()
        bad = [k for k in extra if not k.startswith(pruned)]
        if bad:
            raise KeyError(f"checkpoint keys the model does not have: {bad[:5]}")
        for k in extra:
            del state[k]
        model.load_state_dict(state, strict=True)
        self.model = model.to(self.device).eval()

    @property
    def cascade(self) -> bool:
        return self.cfg.model.family == "cascade"

    def reconstruct(self, xrays, max_stage: Optional[int] = None,
                    return_intermediate: bool = False):
        """xrays (B, 2, 1, S, S) → (B, 1, D, H, W) on the engine's device in
        the model's compute dtype, or (the cascade) a {"stage1": ..., ...}
        dict. The other families have one output and read neither option, as
        in JAX."""
        x = torch.as_tensor(xrays, dtype=torch.float32).to(self.device)
        with torch.inference_mode():
            if not self.cascade:
                return self.model(x)
            return self.model(x, return_intermediate=return_intermediate,
                              max_stage=self.max_stage if max_stage is None else max_stage)

    def _target(self, item: Dict) -> torch.Tensor:
        return torch.as_tensor(item["ct_volume"][None], dtype=torch.float32).to(self.device)

    def evaluate_sample(self, item: Dict, max_stage: Optional[int] = None) -> Dict[str, float]:
        """The metrics of one dataset item against its target resized to the
        output (trilinear, align_corners=False), the output in its compute
        dtype promoted to fp32. The cascade: ``stageN_psnr``, ``stageN_ssim``,
        ``stageN_l1`` for each stage up to max_stage; the other families:
        ``psnr``, ``psnr_dynamic``, ``ssim``, ``l1``."""
        from ..training.trainer import resize_target

        if self.cfg.model.family not in PORTED_FAMILIES:
            raise NotImplementedError(f"model family {self.cfg.model.family!r} is not ported")
        xr = item["drr_stacked"][None]
        target = self._target(item)
        if not self.cascade:
            vol = self.reconstruct(xr)
            t = resize_target(target, vol.shape[-3:])
            return {"psnr": float(psnr(vol, t)), "psnr_dynamic": float(psnr_dynamic_range(vol, t)),
                    "ssim": float(ssim_metric(vol, t)), "l1": float(mae(vol, t))}
        metrics: Dict[str, float] = {}
        outs = self.reconstruct(xr, max_stage=max_stage, return_intermediate=True)
        for stage, vol in outs.items():
            t = resize_target(target, vol.shape[-3:])
            metrics[f"{stage}_psnr"] = float(psnr(vol, t))
            metrics[f"{stage}_ssim"] = float(ssim_metric(vol, t))
            metrics[f"{stage}_l1"] = float(mae(vol, t))
        return metrics

    def evaluate_dataset(self, dataset, out_json: Optional[str] = None,
                         max_stage: Optional[int] = None) -> Dict:
        """Mean and std of every evaluate_sample metric over the dataset;
        with out_json also the per-sample rows, as JSON."""
        rows = [self.evaluate_sample(dataset[i], max_stage) for i in range(len(dataset))]
        summary = {}
        for k in rows[0]:
            vals = np.asarray([r[k] for r in rows], np.float64)
            summary[k] = {"mean": float(vals.mean()), "std": float(vals.std())}
        if out_json:
            Path(out_json).write_text(json.dumps({"per_sample": rows, "summary": summary},
                                                 indent=2))
        return summary

    def diagnose(self, item: Dict, max_stage: int = 1) -> Dict:
        """The diagnostic suite and health grades of one item's reconstruction
        (the cascade's up to ``max_stage``), with the cross-attention
        probabilities captured live where the model has attention (the
        cascade's stage 1, every block of DirectCTRegression; they take the
        plain path for that forward, every other attention launches its
        kernel). The fp32 volume stands in as both prediction and x0, the
        resized target as both target and ground truth."""
        from ..losses.diagnostics import DiagnosticLosses, analyze_component_health
        from ..models.attention import collect_attention_maps
        from ..training.trainer import resize_target

        xr = torch.as_tensor(item["drr_stacked"][None], dtype=torch.float32).to(self.device)
        target = self._target(item)
        kw = {"max_stage": max_stage} if self.cascade else {}
        capture = (self.model.capture_attention() if hasattr(self.model, "capture_attention")
                   else contextlib.nullcontext())
        with torch.inference_mode():
            with capture:
                vol = self.model(xr, **kw)
                maps = collect_attention_maps(self.model)
            vol = vol.float()
            t = resize_target(target, vol.shape[-3:])
            losses = DiagnosticLosses()(vol, t, vol, t, xr, attention_maps=maps or None)
        flat = {k: float(v) for k, v in losses.items() if v.dim() == 0}
        return {"losses": flat, "health": analyze_component_health(losses),
                "captured_attention": sorted(maps)}

    def export(self, xrays, out_dir: str, prefix: str = "pred",
               upscale: Optional[Tuple[int, int, int]] = None, denormalize: bool = False,
               target: Optional[np.ndarray] = None) -> Dict[str, str]:
        """Reconstruct and write ``<prefix>.npy``, ``.nii.gz``, the orthogonal
        mid-slice PNGs and the 18-panel summary figure (whose error and target
        panels and metric title need ``target``, (B, 1, D, H, W) at any
        resolution, resized to the output). The upscale (trilinear,
        align_corners=False) runs in the output's dtype before the
        denormalisation; the ``.npy`` keeps that dtype (bf16 as ``save_npy``
        writes it) unless denormalised, which gives fp32."""
        from ..training.trainer import resize_target

        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        raw = self.reconstruct(xrays)
        vol = raw[0, 0]
        try:
            from ..utils.viz import inference_summary_figure

            t = metrics = None
            if target is not None:
                tt = resize_target(torch.as_tensor(target, dtype=torch.float32).to(self.device),
                                   vol.shape)
                v = raw.float()
                metrics = {"psnr": float(psnr(v, tt)), "ssim": float(ssim_metric(v, tt)),
                           "mae": float(mae(v, tt))}
                t = tt.cpu().numpy()
            fig_path = out / f"{prefix}_summary.png"
            inference_summary_figure(np.asarray(xrays), raw.float().cpu().numpy(), t, metrics,
                                     str(fig_path))
            summary_path = str(fig_path)  # only after a successful write
        except Exception as e:  # matplotlib issues must not kill the export
            print(f"[infer] summary figure skipped: {e}")
            summary_path = None
        if upscale is not None:
            vol = resize_trilinear(vol[None], upscale, align_corners=False)[0]
        host = vol.cpu()  # the .npy keeps the output's dtype ...
        values = host.float().numpy()
        if denormalize:  # ... unless in HU, fp32
            values = host = denormalize_ct(values, self.cfg.data.normalization)
        paths = {}
        if summary_path:
            paths["summary"] = summary_path
        save_npy(out / f"{prefix}.npy", host)
        paths["npy"] = str(out / f"{prefix}.npy")
        try:
            export_nifti(values, out / f"{prefix}.nii.gz")
            paths["nifti"] = str(out / f"{prefix}.nii.gz")
        except Exception as e:
            paths["nifti_error"] = repr(e)
        try:
            export_orthogonal_views(values, str(out / prefix), title=prefix)
            paths["views"] = str(out / f"{prefix}_axial.png")
        except ImportError as e:  # no matplotlib
            print(f"[infer] orthogonal views skipped: {e}")
        return paths
