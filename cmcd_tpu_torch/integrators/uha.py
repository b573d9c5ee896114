"""Uncorrected Hamiltonian Annealing (UHA), batch-first
(cmcd_tpu/integrators/uha.py).

Per bridge: partial momentum refresh rho = eta rho_prev + sqrt(1 - eta^2)
exp(md) xi against the trainable momentum distribution N(0, exp(md)^2), an
lfsteps-step leapfrog under the annealed potential, and the weight update
w += log N(rho_new; 0, e^md) - log N(rho; 0, e^md): the new momentum is
compared with the refreshed one, not with rho_prev. The target score is not
clipped, whatever ctx.grad_clipping says. A per-bridge
delta_H = (U + K)_init - (U + K)_final is returned as a diagnostic, with U
at the z before the first half-kick and K at the rho after it, where the
reference evaluates them.

This eager path calls the target score through autograd; it is the
reference the fused rollout (ops/uha.py) is held against, and torch.autograd
of a loss through it is the exact backprop through time (the oracle of
ops/kl_uha.py).
"""

from __future__ import annotations

import torch

from cmcd_tpu_torch.distributions import diag_gaussian_log_prob, momentum_log_prob
from cmcd_tpu_torch.integrators.base import IntegratorContext, make_grad_u


def evolve_uha(z, betas, params, ctx: IntegratorContext, noise=None, generator=None):
    """Run nbridges UHA bridges. z: (N, dim). Returns (z, w_delta, delta_h),
    delta_h (nbridges, N) (no gradient: a diagnostic).

    noise: optional (nbridges + 1, N, dim) standard normals: noise[0] the
    initial momentum's base draw, noise[i + 1] the refresh draw of bridge i.
    Without it the draws come from `generator`, the initial momentum first.
    """
    md, eta, eps = params["md"], params["eta"], params["eps"]
    vd = params["vd"]
    grad_u = make_grad_u(ctx, vd, None, None)
    inv_var = torch.exp(-2.0 * md)

    def draw(j):
        if noise is not None:
            return noise[j]
        return torch.randn(z.shape, generator=generator, device=z.device)

    def u_value(z, beta):
        return -(beta * ctx.target_log_prob(z) + (1.0 - beta) * diag_gaussian_log_prob(vd, z))

    def k_value(rho):
        return -momentum_log_prob(rho, md)

    def leapfrog(z, rho, beta):
        with torch.no_grad():
            u_init = u_value(z, beta)
        rho = rho - eps * grad_u(z, beta) / 2.0
        with torch.no_grad():
            k_init = k_value(rho)
        z = z + eps * (rho * inv_var)
        for _ in range(ctx.lfsteps - 1):
            rho = rho - eps * grad_u(z, beta)
            z = z + eps * (rho * inv_var)
        with torch.no_grad():
            u_final = u_value(z, beta)
        rho = rho - eps * grad_u(z, beta) / 2.0
        with torch.no_grad():
            delta_h = u_init + k_init - u_final - k_value(rho)
        return z, rho, delta_h

    rho = torch.exp(md) * draw(0)
    w = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
    delta_hs = []
    for i in range(ctx.nbridges):
        beta = betas[i]
        rho = eta * rho + torch.sqrt(1.0 - eta**2) * (torch.exp(md) * draw(i + 1))
        z, rho_new, delta_h = leapfrog(z, rho, beta)
        w = w + momentum_log_prob(rho_new, md) - momentum_log_prob(rho, md)
        rho = rho_new
        delta_hs.append(delta_h)
    return z, w, torch.stack(delta_hs)
