"""Target density interface (cmcd_tpu/targets/base.py).

Every target exposes a batched log-density: log_prob(z) with z (N, dim)
-> (N,). The tractable ones (many_gmm) have ln Z == 0 exactly. Samplers of
the target come with the W2 metric (ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class Target:
    name: str
    dim: int
    log_prob: Callable  # (N, dim) -> (N,)
    # Construction kwargs; the kernel score registry (ops/target_grads.py)
    # reads them so that a target it cannot honour is refused, never
    # integrated against the wrong density.
    params: dict = dataclasses.field(default_factory=dict)
    # What a target builds once and its kernel-form score wraps at no cost
    # (LGCP's float32 matrices and counts, on the target's device).
    constants: dict = dataclasses.field(default_factory=dict)
