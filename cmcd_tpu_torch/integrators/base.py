"""Shared machinery for the annealed-SDE integrators
(cmcd_tpu/integrators/base.py).

State layout: z (N, dim), w (N,) running log-importance-weight.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from cmcd_tpu_torch.distributions import diag_gaussian_grad_log_prob


@dataclasses.dataclass(frozen=True)
class IntegratorContext:
    """Everything an evolve function needs besides (z, betas, params).

    target_log_prob: batched (N, dim) -> (N,)
    apply_sn: batched score net (net, x, i) -> (N, dim), or None
    apply_sn2: MCD_DNF's second (backward) net, the same signature, or None
    """

    target_log_prob: Callable
    nbridges: int
    dim: int
    apply_sn: Optional[Callable] = None
    apply_sn2: Optional[Callable] = None
    eps_schedule: str = ""
    grad_clipping: bool = False
    lfsteps: int = 1  # leapfrog steps per UHA bridge


def target_grad(ctx: IntegratorContext, differentiable: bool = True):
    """Batched d/dz log pi(z): (N, dim) -> (N, dim), through autograd.

    differentiable: keep z in the graph and build the score's own graph
    (create_graph), so that a loss differentiated through the rollout sees
    the score's Jacobian (the KL modes' backprop through time). Off, z is
    detached first: the form of the modes that cut the state from the graph
    themselves (VarGrad)."""

    def grad_pi(z):
        with torch.enable_grad():
            chain = differentiable and z.requires_grad
            if not chain:
                z = z.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(ctx.target_log_prob(z).sum(), z, create_graph=chain)
        return g

    return grad_pi


def make_grad_u(
    ctx: IntegratorContext,
    vd_params,
    clip_target: Optional[float],
    clip_vd: Optional[float],
    differentiable: bool = True,
):
    """gradU(z, beta) = -(beta * grad log pi + (1-beta) * grad log q).

    Clip placement follows the JAX package: CAIS (KL) clips the target score
    at +/-1e3 and leaves the q score alone; CAIS_VAR clips both at +/-1e2;
    None leaves that score unclipped. differentiable: see target_grad.
    """
    grad_pi = target_grad(ctx, differentiable)

    def grad_u(z, beta):
        gu = grad_pi(z)
        gp = diag_gaussian_grad_log_prob(vd_params, z)
        if clip_target is not None:
            gu = torch.clamp(gu, -clip_target, clip_target)
        if clip_vd is not None:
            gp = torch.clamp(gp, -clip_vd, clip_vd)
        return -(beta * gu + (1.0 - beta) * gp)

    return grad_u
