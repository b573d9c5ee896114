"""Utilities of the port: the device default, the JAX <-> port parameter
carrier and JSONL logging (the JAX package's checkpointing, W2, PSIS and
plotting wait for ROADMAP queue A)."""

from cmcd_tpu_torch.utils.device import resolve_device
from cmcd_tpu_torch.utils.logging import MetricLogger, ThroughputMeter

__all__ = ["MetricLogger", "ThroughputMeter", "resolve_device"]
