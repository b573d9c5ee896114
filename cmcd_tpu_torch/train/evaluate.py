"""Evaluation protocol: final ELBO and ln Z over independent seed groups
(cmcd_tpu/train/evaluate.py).

Each seed group is one call of the ELBO function on n_samples chains; on
the fused path that is one kernel launch per group, as JAX's lax.map makes
one kernel call per group.
"""

from __future__ import annotations

import math

import torch

from cmcd_tpu_torch import bounds


def summarize(neg_elbos: torch.Tensor) -> dict:
    """ELBO_s = mean_i(-L_si); ln Z_s = logsumexp_i(-L_si) - log n; means and
    population stds over the seed groups s. neg_elbos: (S, n)."""
    n = neg_elbos.shape[1]
    elbos = -torch.mean(neg_elbos, dim=1)
    ln_zs = torch.logsumexp(-neg_elbos, dim=1) - math.log(n)
    return {
        "final_elbo": float(torch.mean(elbos)),
        "final_elbo_std": float(torch.std(elbos, correction=0)),
        "final_ln_Z": float(torch.mean(ln_zs)),
        "final_ln_Z_std": float(torch.std(ln_zs, correction=0)),
    }


@torch.no_grad()
def evaluate(params, ctx, setup: bounds.CMCDSetup, *, generator=None,
             n_samples: int = 500, n_input_dist_seeds: int = 30, elbo_fn=None):
    """Returns final_elbo / final_ln_Z (+ stds), the (n_seeds, n_samples)
    negative-ELBO matrix and the final samples, both as numpy.

    elbo_fn: optional (params, n, generator) -> (neg_elbos, z), e.g. the
    fused path (ops.compute_elbos_fused); default bounds.compute_elbos.
    """
    if elbo_fn is None:
        def elbo_fn(p, n, g):
            return bounds.compute_elbos(p, n, ctx, setup, generator=g)

    groups = [elbo_fn(params, n_samples, generator) for _ in range(n_input_dist_seeds)]
    neg_elbos = torch.stack([g[0] for g in groups])  # (S, n)
    zs = torch.stack([g[1] for g in groups])         # (S, n, dim)
    out = summarize(neg_elbos)
    out["neg_elbos"] = neg_elbos.cpu().numpy()
    out["samples"] = zs.reshape(-1, zs.shape[-1]).cpu().numpy()
    return out
