"""Patient-folder dataset (counterpart of hybrid_vit_cascade_tpu/data/dataset.py;
reference: utils/dataset.py, the canonical one).

Keeps the reference's on-disk contract — patient folders containing
`{id}_pa_drr.*` / `{id}_lat_drr.*` (PNG or .npy) and `{id}.nii.gz|.nii|.npy`
— and its preprocessing: bilinear DRR resize → [0,1] → normalize range;
trilinear CT resize → HU window → normalize. The two incompatible reference
normalization conventions become explicit presets:

  * 'soft_tissue' — clamp [-200, 200] HU → [-1, 1] (utils/dataset.py:219-229)
  * 'full'        — clamp [-1024, 3071] HU → [0, 1] (dataset_simple.py:103-104)

Pure numpy on the host (no torch); augmentation uses an explicit
np.random.Generator instead of global RNG.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from ..ops.resize import resize_trilinear_np as _np_resize_trilinear

NORMALIZATION_PRESETS = {
    "soft_tissue": {"window": (-200.0, 200.0), "range": (-1.0, 1.0)},
    "full": {"window": (-1024.0, 3071.0), "range": (0.0, 1.0)},
}

_FRONTAL_PATTERNS = ("{pid}_pa_drr.*", "{pid}_pa.*", "{pid}_frontal.*")
_LATERAL_PATTERNS = ("{pid}_lat_drr.*", "{pid}_lat.*", "{pid}_lateral.*")
_CT_EXTS = (".nii.gz", ".nii", ".npy")


def _find_by_patterns(folder: Path, patterns) -> Optional[Path]:
    pid = folder.name
    for pattern in patterns:
        matches = sorted(folder.glob(pattern.format(pid=pid)))
        if matches:
            return matches[0]
    return None


def _find_ct(folder: Path) -> Optional[Path]:
    pid = folder.name
    for ext in _CT_EXTS:
        p = folder / f"{pid}{ext}"
        if p.exists():
            return p
    return None


def _np_resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    return _np_resize_trilinear(img[None], (1, *size))[0]


class PatientDRRDataset:
    """Map-style dataset over patient folders (utils/dataset.py:19-391)."""

    def __init__(
        self,
        data_path: str,
        target_xray_size: int = 512,
        target_volume_size: Tuple[int, int, int] = (256, 256, 256),
        normalization: str = "soft_tissue",
        validate_alignment: bool = False,
        augmentation: bool = False,
        cache_in_memory: bool = False,
        flip_drrs_vertical: bool = False,
        max_patients: Optional[int] = None,
        augment_seed: int = 0,
    ):
        self.data_path = Path(data_path)
        self.target_xray_size = target_xray_size
        self.target_volume_size = tuple(target_volume_size)
        preset = NORMALIZATION_PRESETS[normalization]
        self.hu_window = preset["window"]
        self.normalize_range = preset["range"]
        self.validate_alignment = validate_alignment
        self.augmentation = augmentation
        self.flip_drrs_vertical = flip_drrs_vertical
        self._rng = np.random.default_rng(augment_seed)
        self._cache: Optional[Dict[int, Dict]] = {} if cache_in_memory else None

        self.patient_folders = []
        if self.data_path.exists():
            for folder in sorted(self.data_path.iterdir()):
                if not folder.is_dir() or folder.name.startswith("."):
                    continue
                if (
                    _find_by_patterns(folder, _FRONTAL_PATTERNS)
                    and _find_by_patterns(folder, _LATERAL_PATTERNS)
                    and _find_ct(folder)
                ):
                    self.patient_folders.append(folder)
                    if max_patients is not None and len(self.patient_folders) >= max_patients:
                        break
        if not self.patient_folders:
            raise ValueError(f"No valid patient folders found in {data_path}")

        self.alignment_stats = {"total": 0, "passed": 0, "failed": 0, "avg_error": 0.0}

    def __len__(self) -> int:
        return len(self.patient_folders)

    # --- loading ----------------------------------------------------------
    def _load_image(self, filepath: Path) -> np.ndarray:
        if filepath.suffix == ".npy":
            img = np.load(filepath).astype(np.float32)
            if img.ndim == 3:
                img = img[..., 0] if img.shape[-1] in (1, 3) else img[0]
        else:
            from PIL import Image

            img = np.asarray(Image.open(filepath).convert("L"), dtype=np.float32)
        if img.shape != (self.target_xray_size,) * 2:
            img = _np_resize_bilinear(img, (self.target_xray_size,) * 2)
        if img.max() > 1.0:
            img = img / 255.0
        lo, hi = self.normalize_range
        return (img * (hi - lo) + lo)[None].astype(np.float32)  # (1, H, W)

    def _load_volume(self, filepath: Path) -> np.ndarray:
        from . import native_io

        vol = None
        if filepath.suffix == ".npy":
            vol = np.load(filepath).astype(np.float32)
        else:
            # native C++ fast path (gzip+NIfTI decode); pure-Python fallback
            vol = native_io.read_nifti(filepath)
            if vol is None:
                from .nifti import read_nifti

                vol = read_nifti(filepath)
        if vol.ndim == 4:
            vol = vol[..., 0]
        if vol.shape != self.target_volume_size:
            resized = native_io.resample_trilinear(vol, self.target_volume_size, align_corners=False)
            vol = resized if resized is not None else _np_resize_trilinear(vol, self.target_volume_size)
        w_lo, w_hi = self.hu_window
        lo, hi = self.normalize_range
        out = native_io.window_normalize(vol, (w_lo, w_hi), (lo, hi))
        if out is None:
            out = np.clip(vol, w_lo, w_hi)
            out = (out - w_lo) / (w_hi - w_lo) * (hi - lo) + lo
        return out[None].astype(np.float32)  # (1, D, H, W)

    # --- alignment check (utils/dataset.py:233-283) -----------------------
    def _alignment_error(self, drr_frontal, drr_lateral, ct_volume) -> float:
        synth_f = ct_volume[0].max(axis=0)  # (H, W)
        synth_l = ct_volume[0].max(axis=2)  # (D, H)
        s = (self.target_xray_size,) * 2
        err_f = float(np.mean((drr_frontal[0] - _np_resize_bilinear(synth_f, s)) ** 2))
        err_l = float(np.mean((drr_lateral[0] - _np_resize_bilinear(synth_l, s)) ** 2))
        return (err_f + err_l) / 2.0

    def __getitem__(self, idx: int) -> Dict:
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        folder = self.patient_folders[idx]
        drr_frontal = self._load_image(_find_by_patterns(folder, _FRONTAL_PATTERNS))
        drr_lateral = self._load_image(_find_by_patterns(folder, _LATERAL_PATTERNS))
        ct_volume = self._load_volume(_find_ct(folder))

        if self.flip_drrs_vertical:
            drr_frontal = drr_frontal[:, ::-1].copy()
            drr_lateral = drr_lateral[:, ::-1].copy()

        aligned = True
        if self.validate_alignment:
            err = self._alignment_error(drr_frontal, drr_lateral, ct_volume)
            aligned = err < 0.5
            self.alignment_stats["total"] += 1
            self.alignment_stats["passed" if aligned else "failed"] += 1
            self.alignment_stats["avg_error"] += err

        drr_stacked = np.stack([drr_frontal, drr_lateral])  # (2, 1, H, W)
        if self.augmentation:
            drr_stacked, ct_volume = self._augment(drr_stacked, ct_volume)

        item = {
            "drr_frontal": drr_stacked[0],
            "drr_lateral": drr_stacked[1],
            "drr_stacked": drr_stacked,
            "ct_volume": ct_volume,
            "patient_id": folder.name,
            "aligned": aligned,
        }
        if self._cache is not None:
            self._cache[idx] = item
        return item

    def _augment(self, drr_stacked, ct_volume):
        """h-flip + intensity scale (utils/dataset.py:351-373), explicit RNG."""
        if self._rng.random() > 0.5:
            drr_stacked = drr_stacked[..., ::-1].copy()
            ct_volume = ct_volume[..., ::-1].copy()
        if self._rng.random() > 0.5:
            scale = 0.9 + 0.2 * self._rng.random()
            drr_stacked = drr_stacked * scale
            ct_volume = ct_volume * scale
        lo, hi = self.normalize_range
        return np.clip(drr_stacked, lo, hi), np.clip(ct_volume, lo, hi)

    def get_alignment_report(self) -> Dict:
        tot = self.alignment_stats["total"]
        return {
            "total_validated": tot,
            "passed": self.alignment_stats["passed"],
            "failed": self.alignment_stats["failed"],
            "pass_rate": self.alignment_stats["passed"] / tot if tot else 0.0,
            "average_error": self.alignment_stats["avg_error"] / tot if tot else 0.0,
        }


class _Subset:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


def create_train_val_datasets(
    data_path_or_dataset,
    train_split: float = 0.8,
    val_split: float = 0.1,
    seed: int = 42,
    split_mode: str = "seeded_random",
    **dataset_kwargs,
):
    """Train/val/test split.

    split_mode='seeded_random': seeded permutation (utils/dataset.py:393-428).
    split_mode='sorted_fraction': the simple dataset's deterministic
    contiguous slicing of the SORTED patient order (dataset_simple.py:62-73)
    — train = first int(n·train_split), val = next int(n·val_split), test =
    the rest. Needed to reproduce the reference's exact test membership on a
    real dataset (ignores `seed`)."""
    if isinstance(data_path_or_dataset, (str, Path)):
        full = PatientDRRDataset(str(data_path_or_dataset), **dataset_kwargs)
    else:
        full = data_path_or_dataset
    n = len(full)
    n_train = int(train_split * n)
    n_val = int(val_split * n)
    if split_mode == "sorted_fraction":
        # PatientDRRDataset discovery is sorted-dir already; identity order
        # reproduces the reference's patient_dirs[:n_train] slicing
        perm = np.arange(n)
    elif split_mode == "seeded_random":
        perm = np.random.default_rng(seed).permutation(n)
    else:
        raise ValueError(f"unknown split_mode: {split_mode!r}")
    return (
        _Subset(full, perm[:n_train]),
        _Subset(full, perm[n_train : n_train + n_val]),
        _Subset(full, perm[n_train + n_val :]),
    )
