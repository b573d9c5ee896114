"""Evaluation (the trainer is not ported yet: see ROADMAP queue A)."""

from cmcd_tpu_torch.train.evaluate import evaluate, summarize

__all__ = ["evaluate", "summarize"]
