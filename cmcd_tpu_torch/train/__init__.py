"""Training and evaluation (cmcd_tpu/train)."""

from cmcd_tpu_torch.train.evaluate import evaluate, summarize
from cmcd_tpu_torch.train.trainer import (
    TrainResult,
    create_optimizer,
    mfvi_pretrain,
    project,
    train,
)

__all__ = [
    "TrainResult",
    "create_optimizer",
    "evaluate",
    "mfvi_pretrain",
    "project",
    "summarize",
    "train",
]
