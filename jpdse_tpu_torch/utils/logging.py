"""Structured metrics log, the port of ``jpdse_tpu/utils/logging.py``: one
JSON record per line (``metrics.jsonl``) beside the human-readable
``loss_log.txt`` the training entry point writes."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, save_dir: Optional[str], filename: str = "metrics.jsonl"):
        self.path = os.path.join(save_dir, filename) if save_dir else None
        if self.path:
            os.makedirs(save_dir, exist_ok=True)

    def log(self, step: int, metrics: Dict[str, float], **extra):
        if not self.path:
            return
        rec = {"t": time.time(), "step": step}
        rec.update({k: float(v) for k, v in metrics.items()})
        rec.update(extra)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
