"""Neal's funnel (cmcd_tpu/targets/funnel.py).

  v = z[0] ~ N(0, sig^2);  z[1:] | v ~ N(0, e^v I_{d-1}).

Normalised, so ln Z = 0 exactly. exp(-v) is not clipped, as in the JAX
package. The target's sampler (for the W2 metric) waits for ROADMAP A10.
"""

from __future__ import annotations

import math

import torch

from cmcd_tpu_torch.distributions import LOG_2PI
from cmcd_tpu_torch.targets.base import Target


def make_funnel(d: int = 10, sig: float = 3.0, clip_y: float = 11.0) -> Target:
    def log_prob(z):
        """z: (N, d) -> (N,)."""
        v = z[:, 0]
        log_density_v = -0.5 * (v / sig) ** 2 - 0.5 * LOG_2PI - math.log(sig)
        x = z[:, 1:]
        quad = -0.5 * torch.sum(x * x, dim=-1) * torch.exp(-v)
        log_density_x = quad - 0.5 * (d - 1) * (LOG_2PI + v)
        return log_density_v + log_density_x

    return Target(name="funnel", dim=d, log_prob=log_prob,
                  params={"sig": sig, "clip_y": clip_y})
