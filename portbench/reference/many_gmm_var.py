"""The 40-mode Gaussian mixture in two dimensions (the "many_gmm" target of
the CMCD paper's experiments), for the reference: equal weights, every
component isotropic with scale softplus(0.1), means as committed in
data/many_gmm_means.npy (the paper code's draw: uniform in [-40, 40]^2 from
PRNG key 0). The log-density is floored: below -1e4 it reads -inf.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from portbench.reference.cmcd import LOG_2PI

MEANS = os.path.join(os.path.dirname(__file__), "data", "many_gmm_means.npy")


class ManyGmm:
    dim = 2

    def __init__(self, device, n_mixes: int = 40, log_var_scaling: float = 0.1):
        self.means = torch.from_numpy(np.load(MEANS)).to(device=device, dtype=torch.float32)
        if self.means.shape != (n_mixes, 2):
            raise ValueError(f"many_gmm: {MEANS} holds {tuple(self.means.shape)} means")
        self.scale = math.log1p(math.exp(log_var_scaling))
        self.log_w = -math.log(n_mixes)

    def _comp(self, x):
        d = (x[:, None, :] - self.means[None]) / self.scale
        return -0.5 * torch.sum(d * d, -1) - self.dim * (0.5 * LOG_2PI + math.log(self.scale))

    def log_prob(self, x):
        lp = torch.logsumexp(self._comp(x) + self.log_w, -1)
        return torch.where(lp > -1e4, lp, torch.full_like(lp, -math.inf))

    def score(self, x):
        """grad log pi: sum_k r_k (m_k - x) / s^2, r the components' posterior."""
        r = torch.softmax(self._comp(x), -1)
        return (r @ self.means - x) / (self.scale * self.scale)


def make_target(device):
    return ManyGmm(device)
