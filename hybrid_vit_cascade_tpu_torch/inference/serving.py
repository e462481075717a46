"""Load a serving artifact that ``InferenceEngine.export_serving`` wrote
(counterpart of ``load_serving`` in hybrid_vit_cascade_tpu/inference/infer.py).

The artifact is a ``torch.export`` program: the inference function with the
checkpoint's weights in it, the kernels as ``hvc::`` operator nodes. Loading
it needs no model code, checkpoint or config; this module imports only torch
and the operator module (``ops/cuda/library.py``), whose import registers the
operators that ``torch.export.load`` must find.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import torch

from ..ops.cuda import library  # noqa: F401  (registers the hvc:: operators)


def artifact_device(program: torch.export.ExportedProgram) -> torch.device:
    """The device an exported program's weights live on: the one it was
    exported for."""
    for t in (*program.state_dict.values(), *program.constants.values()):
        if isinstance(t, torch.Tensor):
            return t.device
    raise ValueError("the exported program holds no weights")


def load_serving(path: str | Path,
                 device: str | torch.device = "cuda") -> Callable[..., torch.Tensor]:
    """Load an ``export_serving`` artifact → callable (X-rays, a numpy array
    or tensor of the exported (B, 2, 1, S, S) shape) → the reconstructed
    volume on ``device``, under ``torch.inference_mode``. An artifact runs on
    the device it was exported for (``device`` must be of that type); this
    differs from the JAX artifact, which can be lowered for several
    platforms at once."""
    dev = torch.device(device)
    program = torch.export.load(str(path))
    exported_on = artifact_device(program)
    if exported_on.type != dev.type:
        raise ValueError(f"{path} was exported for {exported_on.type}; it does not run on "
                         f"{dev.type} (export it again with --device {dev.type})")
    module = program.module()

    def serve(xrays) -> torch.Tensor:
        x = torch.as_tensor(xrays, dtype=torch.float32).to(exported_on)
        with torch.inference_mode():
            return module(x)

    return serve
