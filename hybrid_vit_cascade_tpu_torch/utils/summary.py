"""Model summaries (counterpart of hybrid_vit_cascade_tpu/utils/summary.py):
parameter counts of a module, buffers (BatchNorm running statistics)
excluded, as flax keeps ``batch_stats`` apart from ``params``."""

from __future__ import annotations

from typing import Dict

import torch.nn as nn


def count_parameters(module: nn.Module) -> int:
    return int(sum(p.numel() for p in module.parameters()))


def print_model_summary(name: str, module: nn.Module) -> str:
    """Total, fp32 size and the count under each top-level name (a child
    module, or a parameter of the module itself); printed and returned."""
    total = count_parameters(module)
    by_top: Dict[str, int] = {}
    for pname, p in module.named_parameters():
        top = pname.split(".", 1)[0]
        by_top[top] = by_top.get(top, 0) + p.numel()
    lines = [f"=== {name} ===", f"Total parameters: {total:,}",
             f"Model size (fp32): {total * 4 / 1024**2:.2f} MB"]
    lines += [f"  {top}: {n:,}" for top, n in by_top.items()]
    text = "\n".join(lines)
    print(text)
    return text
