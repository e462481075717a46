"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``hybrid_vit_cascade_tpu_torch/csrc/*.cu`` file compiles, in one
``nvcc`` call, into one shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/<hash>/libhvc_kernels.so csrc/*.cu

The library lands under ``build/kernels/`` at the repository root, in a
directory named by a hash of the sources and flags, so an unchanged tree
reuses it and an edited one rebuilds. Nothing is compiled on import: the
first call to :func:`library` (or :func:`build`) does it. No PyTorch headers
are involved, which keeps a cold build to seconds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
LIB_NAME = "libhvc_kernels.so"
# -Xptxas=-v writes each kernel's registers, shared memory and spills to the
# build log (nvcc.log beside the library).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are compiled from "
        f"{CSRC_DIR} at first use and need the CUDA toolkit (nvcc on PATH "
        "or under $CUDA_HOME/bin)")


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def build_dir() -> Path:
    """Directory of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources unless a library for them exists; return its path."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "nvcc.log").write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {res.returncode}:\n{' '.join(cmd)}\n"
            f"{res.stdout}{res.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The compiled kernels, built on the first call of the process."""
    return ctypes.CDLL(str(build()))


@functools.cache
def function(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """C entry point `name` with its argument types declared. Every entry
    point returns a cudaError_t (0 = success)."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
