"""Procedural chest-CT phantoms + synthetic DRR pairs (counterpart of
hybrid_vit_cascade_tpu/data/synthetic.py: the same phantoms, seeds, item
schema, DRR range and opt-in on-disk phantom cache, ``HVC_PHANTOM_CACHE``,
whose file names are the JAX package's, so one cache directory serves both;
numpy only) and ``write_reference_tree``, a patient tree in the real
dataset's layout (PNG DRRs through PIL, which the card's machine lacks: a
CPU-side tool).

Deterministic anatomical phantoms in HU (body, lungs with branching vessel
and airway trees, heart, aorta, vertebrae, ribs; no iid noise, so all fine
detail is structured and projectable), windowed like the real pipeline, and
the AP/lateral DRR pair rendered with a Beer–Lambert projector.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from ..ops.resize import resize_trilinear_np as _np_resize_trilinear


def _paint_polyline(hu: np.ndarray, mask: Optional[np.ndarray], pts: np.ndarray,
                    radius_vox: float, value: float) -> None:
    """Splat spheres of `radius_vox` along a polyline (voxel coords) into hu.
    When `mask` is given, only voxels where mask is True are painted (keeps
    vessels inside the lungs)."""
    size = hu.shape[0]
    r = max(radius_vox, 0.6)
    ri = int(np.ceil(r))
    off = np.mgrid[-ri:ri + 1, -ri:ri + 1, -ri:ri + 1].astype(np.float32)
    ball = (off ** 2).sum(0) <= r * r  # (2ri+1,)³ boolean stamp
    for p in pts:
        iz, iy, ix = int(round(p[0])), int(round(p[1])), int(round(p[2]))
        if not (0 <= iz < size and 0 <= iy < size and 0 <= ix < size):
            continue
        z0, z1 = max(iz - ri, 0), min(iz + ri + 1, size)
        y0, y1 = max(iy - ri, 0), min(iy + ri + 1, size)
        x0, x1 = max(ix - ri, 0), min(ix + ri + 1, size)
        b = ball[z0 - iz + ri:z1 - iz + ri, y0 - iy + ri:y1 - iy + ri, x0 - ix + ri:x1 - ix + ri]
        sl = (slice(z0, z1), slice(y0, y1), slice(x0, x1))
        sel = b & mask[sl] if mask is not None else b
        hu[sl] = np.where(sel, value, hu[sl])


def _grow_tree(rng: np.random.Generator, hu: np.ndarray, mask: Optional[np.ndarray],
               start_u: np.ndarray, direction: np.ndarray, radius_u: float, value: float,
               depth: int, seg_len: Tuple[float, float] = (0.08, 0.13),
               shrink: float = 0.76) -> None:
    """Recursive binary branching tube tree. Coordinates are unit-cube
    ([-0.5, 0.5]) so the anatomy is resolution-independent; rasterization
    stops once the radius falls below ~half a voxel at this resolution."""
    size = hu.shape[0]
    r_vox = radius_u * size
    if depth <= 0 or r_vox < 0.45:
        return
    d = direction / (np.linalg.norm(direction) + 1e-9)
    length = rng.uniform(*seg_len)
    n = max(2, int(length * size / 0.7))
    # slight in-flight curvature
    curve = rng.normal(0.0, 0.25, 3).astype(np.float32)
    ts = np.linspace(0.0, 1.0, n, dtype=np.float32)[:, None]
    dirs = d[None] + curve[None] * ts
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pts_u = start_u[None] + np.cumsum(dirs * (length / n), axis=0)
    pts_v = (np.concatenate([start_u[None], pts_u]) + 0.5) * size
    _paint_polyline(hu, mask, pts_v, r_vox, value)
    end = pts_u[-1]
    end_dir = dirs[-1]
    for _ in range(2):
        child = end_dir + rng.normal(0.0, 0.45, 3)
        _grow_tree(rng, hu, mask, end, child.astype(np.float32), radius_u * shrink,
                   value, depth - 1, seg_len, shrink)


def make_phantom_volume(size: int = 64, seed: int = 0) -> np.ndarray:
    """(size, size, size) float32 chest phantom in HU (≈ [-1000, 700]).

    All fine detail is structured + projectable (see module docstring): the
    DRR pair genuinely constrains it, so cascade refinement at 128³/256³ has
    recoverable signal instead of an iid-noise floor."""
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[0:size, 0:size, 0:size].astype(np.float32) / size - 0.5

    hu = np.full((size, size, size), -1000.0, np.float32)  # air

    def ellipsoid(cz, cy, cx, rz, ry, rx):
        return ((z - cz) / rz) ** 2 + ((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2

    jit = lambda s: float(rng.normal(0, s))
    # body (soft tissue ~40 HU) with a subcutaneous fat ring (~-120 HU)
    rb = ellipsoid(jit(0.01), jit(0.01), jit(0.01), 0.42 + jit(0.01), 0.38 + jit(0.01),
                   0.45 + jit(0.01))
    body = rb <= 1.0
    hu[body] = 40.0
    hu[(rb > 0.80) & body] = -120.0
    # band-limited smooth parenchyma variability (low-order cosines, ±8 HU):
    # fully representable at 64³, so it does not fake high-res detail
    tex = np.zeros_like(hu)
    for _ in range(8):
        k = rng.uniform(-3.0, 3.0, 3).astype(np.float32) * 2.0 * np.pi
        ph = rng.uniform(0.0, 2.0 * np.pi)
        tex += np.cos(k[0] * z + k[1] * y + k[2] * x + ph).astype(np.float32)
    hu[body] += (8.0 / np.sqrt(8.0)) * tex[body]
    # lungs (~-150 HU: inside the soft-tissue window so vessels/airways have
    # in-window contrast after clamping)
    lung_mask = np.zeros_like(body)
    lung_centers = []
    for side in (-1, 1):
        c = (0.02 + jit(0.01), -0.03 + jit(0.01), side * (0.18 + jit(0.008)))
        lung = (ellipsoid(*c, 0.30, 0.24, 0.16) <= 1.0) & body
        lung_mask |= lung
        lung_centers.append(np.array(c, np.float32))
    hu[lung_mask] = -150.0
    # pulmonary vessel trees (~60 HU): thin branching tubes seeded at each
    # hilum — too thin to exist at 64³, crisp at 256³; biplane projections
    # constrain them (classic 2-view angiography), so refinement is learnable
    for c in lung_centers:
        hilum = c.copy()
        hilum[2] *= 0.45  # start near the mediastinum
        out = np.array([0.1, 0.0, np.sign(c[2])], np.float32)
        _grow_tree(rng, hu, lung_mask, hilum, out, radius_u=0.011, value=60.0, depth=5)
        _grow_tree(rng, hu, lung_mask, hilum, np.array([-0.6, 0.3, np.sign(c[2])], np.float32),
                   radius_u=0.009, value=60.0, depth=4)
    # airways (~-550 HU → clamps to the window floor): trachea + bronchi
    carina = np.array([-0.08 + jit(0.01), -0.05, 0.0], np.float32)
    tr = (np.linspace(-0.42, carina[0], max(2, int(0.34 * size)))[:, None]
          * np.array([[1.0, 0.0, 0.0]], np.float32))
    tr = tr + np.array([[0.0, carina[1], 0.0]], np.float32)
    _paint_polyline(hu, body, (tr + 0.5) * size, 0.016 * size, -550.0)
    for side in (-1, 1):
        _grow_tree(rng, hu, lung_mask, carina,
                   np.array([0.8, 0.1, side * 1.0], np.float32),
                   radius_u=0.012, value=-550.0, depth=3)
    # heart (~100 HU) and descending aorta (~150 HU)
    heart = ellipsoid(0.05, 0.02, -0.04 + jit(0.01), 0.14, 0.13, 0.13) <= 1.0
    hu[heart & body] = 100.0
    aorta = (((y - 0.10) ** 2 + (x - (0.06 + jit(0.005))) ** 2) <= 0.030 ** 2) \
        & (np.abs(z) < 0.36) & body
    hu[aorta] = 150.0
    # spine: vertebral bodies (~500 HU, saturate the window) alternating with
    # discs (~120 HU) along z — periodic structure both projections see —
    # plus a spinal canal (~20 HU)
    spine = (((y - 0.22) ** 2 + x ** 2) <= (0.055 + jit(0.003)) ** 2) & body
    vert = np.sin(2.0 * np.pi * z / 0.085 + jit(0.4)) > -0.25
    hu[spine & vert] = 500.0
    hu[spine & ~vert] = 120.0
    canal = (((y - 0.22) ** 2 + x ** 2) <= 0.016 ** 2) & body
    hu[canal] = 20.0
    # rib shells: crisp thin high-HU bands at the body boundary, periodic in z
    rshell = np.sqrt((y / 0.38) ** 2 + (x / 0.45) ** 2)
    shell = (rshell > 0.90) & (rshell < 0.96) & body & ~lung_mask
    ribs = shell & (np.sin(2.0 * np.pi * z / 0.11 + jit(0.5)) > 0.45)
    hu[ribs] = 400.0
    return hu


def window_volume(hu: np.ndarray, preset: str = "soft_tissue") -> np.ndarray:
    """HU → normalized volume (matches dataset presets)."""
    if preset == "soft_tissue":  # utils/dataset.py:219-229 → [-1, 1]
        v = np.clip(hu, -200.0, 200.0)
        return ((v + 200.0) / 400.0 * 2.0 - 1.0).astype(np.float32)
    if preset == "full":  # dataset_simple.py:103-104 → [0, 1]
        v = np.clip(hu, -1024.0, 3071.0)
        return ((v + 1024.0) / 4095.0).astype(np.float32)
    raise ValueError(preset)


def render_drr_pair(volume: np.ndarray, img_size: int = 512, mu: float = 0.3) -> np.ndarray:
    """Beer–Lambert AP + lateral DRRs of a [-1,1] volume → (2, 1, S, S) in [0,1]."""
    att = np.exp(-mu * (volume.astype(np.float32) + 1.0))
    ap = att.sum(axis=0)  # (H, W)
    lat = att.sum(axis=2).T  # (H, D) → matches reference transpose
    out = []
    for img in (ap, lat):
        img = (img - img.min()) / (img.max() - img.min() + 1e-8)
        img = _np_resize_trilinear(img[None], (1, img_size, img_size))[0]
        out.append(img[None])
    return np.stack(out).astype(np.float32)  # (2, 1, S, S)


class SyntheticCTDataset:
    """Deterministic phantom dataset with the PatientDRRDataset item schema."""

    def __init__(
        self,
        num_patients: int = 16,
        volume_size: Tuple[int, int, int] = (64, 64, 64),
        xray_size: int = 512,
        preset: str = "soft_tissue",
        seed: int = 0,
    ):
        self.num_patients = num_patients
        self.volume_size = tuple(volume_size)
        self.xray_size = xray_size
        self.preset = preset
        self.seed = seed
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}

    def __len__(self) -> int:
        return self.num_patients

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if idx in self._cache:
            return self._cache[idx]
        base = max(self.volume_size)
        seed = self.seed * 10007 + idx
        vol = drr = None
        disk = self._disk_cache_path(base, seed)
        if disk is not None and disk.exists():
            try:
                with np.load(disk) as z:
                    vol, drr = z["vol"], z["drr"]
            except Exception:
                vol = drr = None  # a corrupt or partial file: regenerate
        if vol is None:
            hu = make_phantom_volume(base, seed=seed)
            vol = window_volume(hu, self.preset)
            if vol.shape != self.volume_size:
                vol = _np_resize_trilinear(vol, self.volume_size)
            drr = render_drr_pair(vol, self.xray_size)
            if disk is not None:
                self._disk_cache_write(disk, vol, drr)
        # DRRs follow the preset's normalize_range, the convention
        # PatientDRRDataset applies to on-disk images: [-1, 1] for soft_tissue;
        # cache files keep the raw [0, 1] render
        lo, hi = {"soft_tissue": (-1.0, 1.0), "full": (0.0, 1.0)}[self.preset]
        drr_n = (drr * (hi - lo) + lo).astype(np.float32)
        item = {
            "ct_volume": vol[None],  # (1, D, H, W)
            "drr_stacked": drr_n,  # (2, 1, S, S)
            "drr_frontal": drr_n[0],
            "drr_lateral": drr_n[1],
            "patient_id": f"phantom_{idx:04d}",
        }
        self._cache[idx] = item
        return item

    def _disk_cache_path(self, base: int, seed: int) -> Optional[Path]:
        """The on-disk cache file of one phantom, keyed by every generation
        input, when ``HVC_PHANTOM_CACHE=<dir>`` is set and base ≥ 64 (a 256³
        phantom takes seconds on one host core)."""
        root = os.environ.get("HVC_PHANTOM_CACHE")
        if not root or base < 64:
            return None
        d, h, w = self.volume_size
        return Path(root) / (f"ph_v2_b{base}_s{seed}_{d}x{h}x{w}"
                             f"_x{self.xray_size}_{self.preset}.npz")

    @staticmethod
    def _disk_cache_write(path: Path, vol: np.ndarray, drr: np.ndarray) -> None:
        """Best effort, atomic: written to a temporary file and renamed, so a
        concurrent reader never sees a partial file."""
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".npz")
            with os.fdopen(fd, "wb") as f:
                np.savez(f, vol=vol, drr=drr)
            os.replace(tmp, path)
        except Exception:
            pass


def write_reference_tree(root, num_patients: int = 4, base_size: int = 64, xray_size: int = 512,
                         seed: int = 0) -> list:
    """Write phantoms as a patient tree in the layout ``PatientDRRDataset``
    reads: ``<root>/<pid>/{<pid>_pa_drr.png, <pid>_lat_drr.png, <pid>.nii.gz}``,
    the volume in raw HU through the port's NIfTI writer (``data/nifti.py``),
    the DRRs as 8-bit PNGs rendered from the soft-tissue-windowed volume.
    Needs PIL, so it runs where PIL is installed (not on the card's machine).
    Returns the patient ids."""
    from PIL import Image

    from .nifti import write_nifti

    root = Path(root)
    pids = []
    for i in range(num_patients):
        pid = f"patient{i:03d}"
        d = root / pid
        d.mkdir(parents=True, exist_ok=True)
        hu = make_phantom_volume(base_size, seed=seed * 10007 + i)
        write_nifti(d / f"{pid}.nii.gz", hu.astype(np.float32))
        drr = render_drr_pair(window_volume(hu, "soft_tissue"), xray_size)
        for view, name in ((drr[0, 0], "pa_drr"), (drr[1, 0], "lat_drr")):
            img = np.clip(view * 255.0 + 0.5, 0, 255).astype(np.uint8)
            Image.fromarray(img).save(d / f"{pid}_{name}.png")  # uint8 (H, W): mode L
        pids.append(pid)
    return pids
