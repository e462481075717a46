"""ctypes bindings for the native IO library (native/nifti_io.cpp at the
repository root); the counterpart of hybrid_vit_cascade_tpu/data/native_io.py.

Fast path for the host input pipeline: C++ gzip+NIfTI decode, threaded
trilinear resample and fused HU window/normalize. Falls back to
nibabel/numpy transparently when the shared library isn't built
(`make -C native`). This is host data IO, not a device kernel: the numpy
fallback stays, as in the JAX package. Unlike the JAX module, the one
attempt to build the library is not switched off by an environment variable.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATHS = [_NATIVE_DIR / "libnifti_io.so"]

_lib = None
_build_attempted = False


def _try_build() -> None:
    """Build the library from source once per process (the .so is not
    versioned — it must come from `make -C native`). Failure is fine: every
    caller falls back to the numpy path."""
    global _build_attempted
    if _build_attempted:
        return
    _build_attempted = True
    import subprocess

    if not (_NATIVE_DIR / "Makefile").exists():
        return
    try:
        subprocess.run(
            ["make", "-C", str(_NATIVE_DIR)],
            capture_output=True, timeout=120, check=False,
        )
    except (OSError, subprocess.SubprocessError):
        pass


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not any(p.exists() for p in _LIB_PATHS):
        _try_build()
    for p in _LIB_PATHS:
        if p.exists():
            try:
                lib = ctypes.CDLL(str(p))
            except OSError:
                continue
            lib.nifti_get_dims.restype = ctypes.c_int
            lib.nifti_get_dims.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
            lib.nifti_read_f32.restype = ctypes.c_int
            lib.nifti_read_f32.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
            lib.resample_trilinear_f32.restype = None
            lib.resample_trilinear_f32.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int,
            ]
            lib.window_normalize_f32.restype = None
            lib.window_normalize_f32.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ]
            _lib = lib
            return _lib
    return None


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_nifti(path: str) -> Optional[np.ndarray]:
    """Read a NIfTI volume as fp32 (nx, ny, nz), matching nibabel's
    get_fdata element order. None if the native lib is unavailable or the
    file needs the fallback (byte-swapped, exotic dtype)."""
    lib = _load()
    if lib is None:
        return None
    dims = (ctypes.c_int64 * 3)()
    if lib.nifti_get_dims(str(path).encode(), dims) != 0:
        return None
    nx, ny, nz = int(dims[0]), int(dims[1]), int(dims[2])
    if nx <= 0 or ny <= 0 or nz <= 0:
        return None
    flat = np.empty(nx * ny * nz, np.float32)
    if lib.nifti_read_f32(str(path).encode(), _fptr(flat), flat.size) != 0:
        return None
    return flat.reshape((nx, ny, nz), order="F")


def resample_trilinear(vol: np.ndarray, out_shape: Tuple[int, int, int],
                       align_corners: bool = False, num_threads: int = 0) -> Optional[np.ndarray]:
    """Threaded C++ trilinear resample of a C-contiguous fp32 volume."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(vol, np.float32)
    dst = np.empty(out_shape, np.float32)
    lib.resample_trilinear_f32(
        _fptr(src), *[ctypes.c_int64(s) for s in src.shape],
        _fptr(dst), *[ctypes.c_int64(s) for s in out_shape],
        int(align_corners), num_threads,
    )
    return dst


def window_normalize(vol: np.ndarray, window: Tuple[float, float], out_range: Tuple[float, float],
                     num_threads: int = 0) -> Optional[np.ndarray]:
    """In-place fused clip+normalize on a C-contiguous fp32 volume."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(vol, np.float32)
    lib.window_normalize_f32(_fptr(v), v.size, window[0], window[1], out_range[0], out_range[1], num_threads)
    return v
