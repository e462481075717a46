"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions
(counterpart of hybrid_vit_cascade_tpu/ops/pallas).

Each kernel wrapper counts the launches of its kernel in ``.launches``;
``launch_counts`` reads them all and ``reset_launch_counts`` sets them to 0.
"""

from __future__ import annotations

from typing import Dict


def _wrappers() -> dict:
    from . import conv3d_k3 as ck
    from . import flash_attention as fa

    return {"flash_attention": fa.flash_attention_fwd, "conv3d_k3s1": ck.conv3d_k3s1,
            "conv3d_k3s2": ck.conv3d_k3s2, "flash_attention_bwd": fa.flash_attention_bwd,
            "conv3d_k3s1_wgrad": ck.conv3d_k3s1_wgrad, "conv3d_k3s1_dgrad": ck.conv3d_k3s1_dgrad,
            "conv3d_k3s2_dgrad": ck.conv3d_k3s2_dgrad, "conv3d_k3s2_wgrad": ck.conv3d_k3s2_wgrad}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset (conv3d_k3s1_dgrad:
    kernel B launched as the stride-1 data gradient, not counted under
    conv3d_k3s1)."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
