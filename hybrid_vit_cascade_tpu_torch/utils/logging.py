"""Metric logging: CSV with header-once append (the reference's log format,
train_direct256_scratch.py:218-224) plus structured JSONL; a copy of
hybrid_vit_cascade_tpu/utils/logging.py."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional, Sequence


class CSVLogger:
    """epoch,phase,loss,psnr,ssim,lr,time rows; header written once."""

    def __init__(self, path: str, fields: Sequence[str] = ("epoch", "phase", "loss", "psnr", "ssim", "lr", "time")):
        self.path = Path(path)
        self.fields = list(fields)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if not self.path.exists():
            self.path.write_text(",".join(self.fields) + "\n")

    def log(self, **row) -> None:
        vals = [str(row.get(f, "")) for f in self.fields]
        with self.path.open("a") as f:
            f.write(",".join(vals) + "\n")


class JSONLLogger:
    def __init__(self, path: str):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, record: Dict, ts: Optional[float] = None) -> None:
        record = {"ts": ts if ts is not None else time.time(), **record}
        with self.path.open("a") as f:
            f.write(json.dumps(record, default=float) + "\n")
