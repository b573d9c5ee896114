"""The 40-mode two-dimensional GMM target (cmcd_tpu/targets/gmm.py
make_many_gmm).

The means are drawn in the JAX package with jax.random.uniform(PRNGKey(0));
torch cannot regenerate those bits, so they are committed as data
(`data/many_gmm_means.npy`, written once from JAX and checked equal to it by
the tests). Only the default construction is served: other n_mixes,
loc_scaling or seed raise.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from cmcd_tpu_torch.distributions import LOG_2PI
from cmcd_tpu_torch.targets.base import Target

MEANS_PATH = os.path.join(os.path.dirname(__file__), "data", "many_gmm_means.npy")


def many_gmm_means(device=None) -> torch.Tensor:
    """(40, 2) f32 component means, identical to the JAX package's."""
    return torch.from_numpy(np.load(MEANS_PATH)).to(device)


def many_gmm_scale(log_var_scaling: float = 0.1) -> float:
    """Per-dim component scale. Reference quirk kept: softplus, not exp."""
    return math.log1p(math.exp(log_var_scaling))


def make_many_gmm(
    n_mixes: int = 40,
    loc_scaling: float = 40.0,
    log_var_scaling: float = 0.1,
    seed: int = 0,
    device=None,
) -> Target:
    if (n_mixes, float(loc_scaling), seed) != (40, 40.0, 0):
        raise NotImplementedError(
            "many_gmm: only n_mixes=40, loc_scaling=40, seed=0 are committed "
            "as data; other draws need the JAX PRNG (see ROADMAP)"
        )
    dim = 2
    means = many_gmm_means(device)
    scale = torch.full(
        (n_mixes, dim), many_gmm_scale(log_var_scaling), device=device
    )
    log_weights = torch.full((n_mixes,), math.log(1.0 / n_mixes), device=device)

    def log_prob(x):
        """x: (N, 2) -> (N,). Floor at -1e4 -> -inf."""
        diff = (x[:, None, :] - means[None]) / scale[None]  # (N, K, 2)
        comp_lp = -0.5 * torch.sum(diff * diff + LOG_2PI, dim=-1) - torch.sum(
            torch.log(scale), dim=-1
        )
        lp = torch.logsumexp(comp_lp + log_weights, dim=-1)
        return torch.where(lp > -1e4, lp, torch.full_like(lp, -math.inf))

    return Target(
        name="many_gmm",
        dim=dim,
        log_prob=log_prob,
        params={
            "n_mixes": n_mixes,
            "loc_scaling": loc_scaling,
            "log_var_scaling": log_var_scaling,
            "seed": seed,
        },
    )
