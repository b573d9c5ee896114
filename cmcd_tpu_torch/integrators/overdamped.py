"""Overdamped (Langevin) annealed-SDE integrators, batch-first
(cmcd_tpu/integrators/overdamped.py).

Forward kernel:  z' ~ N(z - eps * gradU(z, b) [- eps * sn(z, i)], 2 eps I)
Backward kernel: log N(z; z' - eps * gradU(z', b) [+ eps * sn(z', i+off)], 2 eps I)
Weight update:   w += log B - log F

MCD_DNF drops gradU from both means (zero_drift) and forms the backward mean
with a second net, sn2(z', i + 1) (use_sn2_bwd); the target enters only
through the final log pi(z_K).

This eager path calls the target score through autograd and the net once
per use, step by step; it is the reference the fused rollout
(ops/overdamped.py) is held against. Without stop_grad_state the score stays
differentiable in z, so torch.autograd of a loss through the rollout is the
exact backprop through time (the oracle of ops/kl.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from cmcd_tpu_torch.distributions import kernel_log_prob
from cmcd_tpu_torch.integrators.base import IntegratorContext, make_grad_u
from cmcd_tpu_torch.schedules import eps_at_step


@dataclasses.dataclass(frozen=True)
class OverdampedSpec:
    fwd_sn: bool = False          # score net in the forward drift (CAIS)
    bwd_sn: bool = False          # score net in the backward mean
    bwd_sn_offset: int = 0        # 0 for ULA_sn, 1 for CAIS
    stop_grad_state: bool = False  # VarGrad: cut BPTT through the state
    clip_target: Optional[float] = None  # grad clip when ctx.grad_clipping
    clip_vd: Optional[float] = None
    zero_drift: bool = False      # DNF: annealed drift removed entirely
    use_sn2_bwd: bool = False     # DNF: backward uses the second net


ULA = OverdampedSpec()
ULA_SN = OverdampedSpec(bwd_sn=True, bwd_sn_offset=0)
CAIS = OverdampedSpec(
    fwd_sn=True, bwd_sn=True, bwd_sn_offset=1, clip_target=1e3, clip_vd=None
)
CAIS_VAR = OverdampedSpec(
    fwd_sn=True,
    bwd_sn=True,
    bwd_sn_offset=1,
    stop_grad_state=True,
    clip_target=1e2,
    clip_vd=1e2,
)
DNF = OverdampedSpec(
    fwd_sn=True, bwd_sn=True, bwd_sn_offset=1, zero_drift=True, use_sn2_bwd=True
)


def evolve_overdamped(
    z, betas, params, ctx: IntegratorContext, spec: OverdampedSpec,
    noise=None, generator=None,
):
    """Run nbridges overdamped steps. z: (N, dim). Returns (z, w_delta, aux).

    noise: optional (nbridges, N, dim) standard normals replacing the
    per-step draws from `generator`.
    """
    if spec.zero_drift:
        grad_u = lambda zz, bb: torch.zeros_like(zz)
    else:
        clips = (spec.clip_target, spec.clip_vd) if ctx.grad_clipping else (None, None)
        grad_u = make_grad_u(ctx, params["vd"], *clips, differentiable=not spec.stop_grad_state)
    apply_sn = ctx.apply_sn
    apply_sn_bwd, bwd_net = ((ctx.apply_sn2, params["sn2"]) if spec.use_sn2_bwd
                             else (ctx.apply_sn, params.get("sn")))

    w = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
    for i in range(ctx.nbridges):
        if spec.stop_grad_state:
            z = z.detach()
        beta = betas[i]
        eps = eps_at_step(params["eps"], i, ctx.nbridges, ctx.eps_schedule)
        scale = torch.sqrt(2.0 * torch.as_tensor(eps))

        fk_mean = z - eps * grad_u(z, beta)
        if spec.fwd_sn:
            fk_mean = fk_mean - eps * apply_sn(params["sn"], z, i)

        if noise is None:
            xi = torch.randn(z.shape, generator=generator, device=z.device)
        else:
            xi = noise[i]
        z_new = fk_mean + scale * xi
        if spec.stop_grad_state:
            z_new = z_new.detach()

        bk_mean = z_new - eps * grad_u(z_new, beta)
        if spec.bwd_sn:
            bk_mean = bk_mean + eps * apply_sn_bwd(bwd_net, z_new, i + spec.bwd_sn_offset)

        w = w + kernel_log_prob(z, bk_mean, scale) - kernel_log_prob(
            z_new, fk_mean, scale
        )
        z = z_new
    return z, w, None
