"""Underdamped (leapfrog) annealed-SDE integrators, batch-first
(cmcd_tpu/integrators/underdamped.py).

One stepper for the seven modes, each an UnderdampedSpec:
- MCD_U_a-lp / -sna / -sn: OU ("approximate") momentum refresh
  rho' ~ N(rho (1 - gamma eps), 2 gamma eps I)
- MCD_U_e-lp / -sna: exact refresh rho' ~ N(eta rho, (1 - eta^2) I)
- MCD_U_ea-lp-sn: exact forward with eta = exp(-gamma eps), approximate
  backward (the two kernels' scales differ)
- MCD_CAIS_UHA_sn: the score net in both momentum kernels on [z, rho], the
  cosine eps schedule and the target score clipped at +-1e2 (always, whatever
  ctx.grad_clipping says, as in the JAX package)

Per step: refresh, one leapfrog step, the backward momentum kernel's mean
(score-net corrected for the sn modes), w += log B - log F. Before the first
step w -= log N(rho_0; 0, I), after the last w += log N(rho_K; 0, I).

This eager path calls the target score through autograd and the net once
per use; it is the reference the fused rollout (ops/underdamped.py) is held
against. The score stays differentiable in z, so torch.autograd of a loss
through the rollout is the exact backprop through time (the oracle of
ops/kl_underdamped.py).
"""

from __future__ import annotations

import dataclasses

import torch

from cmcd_tpu_torch.distributions import kernel_log_prob, std_normal_log_prob
from cmcd_tpu_torch.integrators.base import IntegratorContext, make_grad_u
from cmcd_tpu_torch.schedules import eps_cosine_sq


@dataclasses.dataclass(frozen=True)
class UnderdampedSpec:
    refresh: str = "approx"   # "approx" | "exact" | "exact_fwd"
    bwd_sn: str = "none"      # "none" | "state" (z only) | "full" ([z, rho'])
    fwd_sn: bool = False      # CAIS: score net in the forward refresh too
    cais: bool = False        # CAIS: cosine eps schedule + clipped target score


U_A_LP = UnderdampedSpec(refresh="approx", bwd_sn="none")
U_A_LP_SNA = UnderdampedSpec(refresh="approx", bwd_sn="state")
U_A_LP_SN = UnderdampedSpec(refresh="approx", bwd_sn="full")
U_E_LP = UnderdampedSpec(refresh="exact", bwd_sn="none")
U_E_LP_SNA = UnderdampedSpec(refresh="exact", bwd_sn="state")
U_EA_LP_SN = UnderdampedSpec(refresh="exact_fwd", bwd_sn="full")
CAIS_UHA = UnderdampedSpec(refresh="approx", bwd_sn="full", fwd_sn=True, cais=True)

# CAIS_UHA clips the target score at +-1e2 and leaves the variational score
# alone (the reference's underdamped CAIS evolver).
CAIS_UHA_CLIP = 1e2


def evolve_underdamped(
    z, betas, params, ctx: IntegratorContext, spec: UnderdampedSpec,
    noise=None, generator=None,
):
    """Run nbridges underdamped leapfrog steps. z: (N, dim). Returns
    (z, w_delta, aux); w_delta holds the two endpoint momentum terms.

    noise: optional (nbridges + 1, N, dim) standard normals: noise[0] the
    initial momentum, noise[i + 1] the refresh draw of step i. Without it the
    draws come from `generator`, the initial momentum first.
    """
    grad_u = make_grad_u(ctx, params["vd"], CAIS_UHA_CLIP if spec.cais else None, None)
    apply_sn = ctx.apply_sn
    gamma, eta, eps0 = params["gamma"], params["eta"], params["eps"]

    def draw(j):
        if noise is not None:
            return noise[j]
        return torch.randn(z.shape, generator=generator, device=z.device)

    rho = draw(0)
    w = -std_normal_log_prob(rho)
    for i in range(ctx.nbridges):
        beta = betas[i]
        eps = eps_cosine_sq(eps0, i, ctx.nbridges) if spec.cais else eps0

        # Forward momentum refresh.
        if spec.refresh == "approx":
            eta_aux = gamma * eps
            fk_mean = rho * (1.0 - eta_aux)
            fwd_scale = torch.sqrt(2.0 * eta_aux)
            bwd_scale = fwd_scale
        elif spec.refresh == "exact":
            fk_mean = eta * rho
            fwd_scale = torch.sqrt(1.0 - eta**2)
            bwd_scale = fwd_scale
        elif spec.refresh == "exact_fwd":
            # eta_aux from the unscheduled eps, as the reference.
            eta_aux = gamma * eps0
            eta_e = torch.exp(-eta_aux)
            fk_mean = eta_e * rho
            fwd_scale = torch.sqrt(1.0 - eta_e**2)
            bwd_scale = torch.sqrt(2.0 * eta_aux)
        else:
            raise ValueError(spec.refresh)
        if spec.fwd_sn:
            fk_mean = fk_mean - 2.0 * eta_aux * apply_sn(params["sn"], torch.cat([z, rho], -1), i)
        rho_prime = fk_mean + fwd_scale * draw(i + 1)

        # One leapfrog step.
        rho_pp = rho_prime - eps * grad_u(z, beta) / 2.0
        z_new = z + eps * rho_pp
        rho_new = rho_pp - eps * grad_u(z_new, beta) / 2.0

        # Backward momentum kernel mean.
        if spec.refresh == "exact":
            bk_mean, gain = eta * rho_prime, 2.0 * (1.0 - eta)
        else:
            bk_mean, gain = rho_prime * (1.0 - eta_aux), 2.0 * eta_aux
        if spec.bwd_sn == "state":
            bk_mean = bk_mean + gain * apply_sn(params["sn"], z, i)
        elif spec.bwd_sn == "full":
            bk_mean = bk_mean + gain * apply_sn(params["sn"], torch.cat([z, rho_prime], -1), i)

        w = w + kernel_log_prob(rho, bk_mean, bwd_scale) - kernel_log_prob(
            rho_prime, fk_mean, fwd_scale)
        z, rho = z_new, rho_new
    w = w + std_normal_log_prob(rho)
    return z, w, None
