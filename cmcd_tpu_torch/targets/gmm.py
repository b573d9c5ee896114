"""The two-dimensional Gaussian-mixture targets (cmcd_tpu/targets/gmm.py).

- make_gmm: the 3-component anisotropic mixture, symmetrised as
  logaddexp(f(x), f(flip x)) - log 2; normalised, ln Z = 0.
- make_many_gmm: the 40-mode GMM; normalised, ln Z = 0.

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

# The 3-mode mixture's components, as the JAX package states them.
GMM_MEANS = np.array([[3.0, 0.0], [-2.5, 0.0], [2.0, 3.0]])
GMM_COVS = np.array(
    [
        [[0.7, 0.0], [0.0, 0.05]],
        [[0.7, 0.0], [0.0, 0.05]],
        [[1.0, 0.95], [0.95, 1.0]],
    ]
)


def gmm_constants():
    """(means (3, 2), Cholesky factors (3, 2, 2), their inverses, the
    per-component log-normalisers (3,)) of the 3-mode mixture, float64 numpy."""
    chols = np.linalg.cholesky(GMM_COVS)
    log_norm = -LOG_2PI - np.sum(np.log(np.diagonal(chols, axis1=-2, axis2=-1)), axis=-1)
    return GMM_MEANS, chols, np.linalg.inv(chols), log_norm


def make_gmm(device=None) -> Target:
    _, _, inv_chols, log_norm = gmm_constants()
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    means, inv_chols, log_norm = f32(GMM_MEANS), f32(inv_chols), f32(log_norm)
    log_weight = math.log(1.0 / 3.0)

    def raw_log_density(x):
        """x: (N, 2) -> (N,)."""
        diff = x[:, None, :] - means[None].to(x.dtype)                       # (N, 3, 2)
        y = torch.einsum("kij,nkj->nki", inv_chols.to(x.dtype), diff)
        maha = -0.5 * torch.sum(y * y, dim=-1)                               # (N, 3)
        return torch.logsumexp(maha + log_norm.to(x.dtype) + log_weight, dim=-1)

    def log_prob(x):
        # logaddexp(a, b) as a logsumexp: torch's logaddexp has a second
        # derivative of inf / inf (NaN) where |a - b| passes ~88, and the
        # eager KL loss differentiates the score.
        a = raw_log_density(x)
        b = raw_log_density(torch.flip(x, dims=(-1,)))
        return torch.logsumexp(torch.stack([a, b]), dim=0) - math.log(2.0)

    return Target(name="gmm", dim=2, log_prob=log_prob)


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
