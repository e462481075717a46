"""Optional wandb logging (counterpart of
hybrid_vit_cascade_tpu/utils/wandb_compat.py, the port's own copy, with its
contract): if wandb is not installed or not initialised, every function is a
silent no-op."""

from __future__ import annotations

from typing import Dict, Optional

try:
    import wandb  # noqa: F401

    WANDB_AVAILABLE = True
except ImportError:
    WANDB_AVAILABLE = False
    wandb = None

PROJECT = "hybrid-vit-cascade-tpu"  # the wandb project every run logs to
_active = False


def init(config: dict) -> bool:
    """Start a wandb run under PROJECT with ``config``; False (and nothing
    done) without wandb."""
    global _active
    if not WANDB_AVAILABLE:
        return False
    wandb.init(project=PROJECT, config=config)
    _active = True
    return True


def log(metrics: Dict, step: Optional[int] = None) -> None:
    if _active and WANDB_AVAILABLE:
        wandb.log(metrics, step=step)


def log_images(images: Dict[str, str], step: Optional[int] = None) -> None:
    """Log saved figure files as wandb Images ({key: png_path}); a silent
    no-op when wandb is absent or inactive."""
    if _active and WANDB_AVAILABLE:
        wandb.log({k: wandb.Image(path) for k, path in images.items()}, step=step)

