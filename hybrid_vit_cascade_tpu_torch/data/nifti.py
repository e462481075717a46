"""Minimal pure-Python NIfTI-1 codec (no nibabel dependency); a copy of
hybrid_vit_cascade_tpu/data/nifti.py, numpy only.

The reference reads CT volumes with nibabel (utils/dataset.py:199-201) and
writes predictions with nib.save (inference scripts). nibabel is not
available in this environment, so this module implements the needed NIfTI-1
subset directly: single-file .nii / .nii.gz, 3-D volumes, common dtypes,
scl_slope/scl_inter scaling, diagonal affine on write. The C++ reader
(native/nifti_io.cpp) is the fast path; this is the portable fallback and
the writer.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path
from typing import Tuple

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _read_bytes(path: str | Path) -> bytes:
    p = Path(path)
    raw = p.read_bytes()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return raw


def read_nifti(path: str | Path) -> np.ndarray:
    """Read a 3-D volume as float64-equivalent fp32 array shaped (nx, ny, nz)
    in nibabel's get_fdata element order (Fortran)."""
    raw = _read_bytes(path)
    if len(raw) < 348:
        raise ValueError(f"{path}: truncated NIfTI header")
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    if sizeof_hdr != 348:
        raise ValueError(f"{path}: unsupported NIfTI (byte-swapped or NIfTI-2)")
    dim = struct.unpack_from("<8h", raw, 40)
    datatype, bitpix = struct.unpack_from("<2h", raw, 70)
    vox_offset = struct.unpack_from("<f", raw, 108)[0]
    scl_slope, scl_inter = struct.unpack_from("<2f", raw, 112)
    nx, ny, nz = int(dim[1]), int(dim[2]), max(1, int(dim[3]))
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported datatype {datatype}")
    np_dtype = _DTYPES[datatype]
    n = nx * ny * nz
    off = int(vox_offset)
    data = np.frombuffer(raw, dtype=np_dtype, count=n, offset=off)
    out = data.astype(np.float32)
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        out = out * np.float32(slope) + np.float32(scl_inter)
    return out.reshape((nx, ny, nz), order="F")


def write_nifti(
    path: str | Path,
    volume: np.ndarray,
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> None:
    """Write a 3-D fp32 volume as single-file NIfTI-1 (.nii or .nii.gz) with a
    diagonal sform affine."""
    vol = np.asarray(volume, np.float32)
    assert vol.ndim == 3, vol.shape
    nx, ny, nz = vol.shape
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, nx, ny, nz, 1, 1, 1, 1)
    struct.pack_into("<2h", hdr, 70, _CODES[np.dtype(np.float32)], 32)  # datatype, bitpix
    struct.pack_into("<8f", hdr, 76, 1.0, *spacing, 1.0, 1.0, 1.0, 1.0)  # pixdim
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope/inter
    struct.pack_into("<b", hdr, 123, 10)  # xyzt_units: mm | sec
    struct.pack_into("<2h", hdr, 252, 0, 1)  # qform_code=0, sform_code=1
    struct.pack_into("<4f", hdr, 280, spacing[0], 0, 0, 0)  # srow_x
    struct.pack_into("<4f", hdr, 296, 0, spacing[1], 0, 0)  # srow_y
    struct.pack_into("<4f", hdr, 312, 0, 0, spacing[2], 0)  # srow_z
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + b"\x00" * 4 + vol.tobytes(order="F")
    p = Path(path)
    if p.suffix == ".gz" or str(p).endswith(".nii.gz"):
        p.write_bytes(gzip.compress(payload, compresslevel=1))
    else:
        p.write_bytes(payload)
