"""Metric logging to a JSONL file, one line per logged epoch.

Counterpart of `MetricLogger` in `pulse_tpu/utils/logger.py` without its
optional wandb and tensorboard sinks: JSONL is the record there too.
"""

from __future__ import annotations

import json
import os
from typing import Any


class MetricLogger:
    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.jsonl_path = os.path.join(out_dir, "metrics.jsonl")

    def log(self, metrics: dict[str, Any], step: int) -> None:
        row = {k: (float(v) if hasattr(v, "item") or isinstance(v, float) else v) for k, v in metrics.items()}
        row["epoch"] = step
        with open(self.jsonl_path, "a") as fh:
            fh.write(json.dumps(row) + "\n")
