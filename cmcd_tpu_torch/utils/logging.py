"""Metrics logging (cmcd_tpu/utils/logging.py; the port's own copy).

MetricLogger writes JSONL locally; the JAX package's optional wandb
forwarding is left out. ThroughputMeter converts optimizer steps per second
into chain-steps per second.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricLogger:
    def __init__(self, jsonl_path: str = ""):
        self._fh = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._fh = open(jsonl_path, "a")
        self._t0 = time.time()

    def log(self, metrics: dict, step: Optional[int] = None):
        if self._fh is None:
            return
        record = dict(metrics)
        if step is not None:
            record["step"] = step
        record["wall_time"] = round(time.time() - self._t0, 3)
        self._fh.write(json.dumps(record, default=float) + "\n")
        self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class ThroughputMeter:
    """Chain-steps per second from optimizer steps per second. The rate
    itself is measured in the trainer, between host reads of whole chunks."""

    def __init__(self, chains_per_step: int, bridges_per_step: int):
        self.chain_steps_per_iter = chains_per_step * bridges_per_step

    def chain_rate(self, steps_per_sec: float) -> float:
        return steps_per_sec * self.chain_steps_per_iter
