"""The fused VarGrad training loss: kernel forward, kernel backward
(cmcd_tpu/ops/fused_train.py: _make_evolve, neg_elbos_pallas,
var_bound_pallas).

var_bound_fused stands in for bounds.var_bound on MCD_CAIS_var_sn: the same
(loss, (neg_elbos, z)) contract and the same math, but the K-step rollout
runs in the fused rollout kernel with its trajectory stored
(ops/overdamped.py) and the gradient in the replay backward kernel
(ops/vargrad.py), joined by a torch.autograd.Function.

Everything outside the bridge loop stays plain autograd, as in JAX: the
reparameterised initial term -log q(z0(theta)), the chain rule from
mgridref_y to betas, the variance and its clip. Only the summed per-step
log-weight increments have the custom backward. The chain states and the
final-state target term are cut from the graph, as the VarGrad integrator
does (integrators/overdamped.py, stop_grad_state).

On CPU tensors the Function runs the two plain versions; on CUDA tensors it
launches the kernels or raises.
"""

from __future__ import annotations

import torch

from cmcd_tpu_torch import bounds
from cmcd_tpu_torch.distributions import diag_gaussian_log_prob, diag_gaussian_sample
from cmcd_tpu_torch.integrators import overdamped as od
from cmcd_tpu_torch.ops.fused import supports_fused
from cmcd_tpu_torch.ops.overdamped import evolve_overdamped_fused
from cmcd_tpu_torch.ops.target_grads import score_for_target
from cmcd_tpu_torch.ops.vargrad import evolve_vargrad_bwd_replay
from cmcd_tpu_torch.ops.vargrad import kernel_fits as backward_fits
from cmcd_tpu_torch.schedules import betas_from_grid


def supports_fused_train(setup: bounds.CMCDSetup, target) -> bool:
    """True if the fused training loss can run: what supports_fused asks of
    the rollout, the VarGrad mode, and a net that also fits one block of the
    backward kernel (ops/vargrad.kernel_fits)."""
    return (
        supports_fused(setup, target)
        and setup.mode == "MCD_CAIS_var_sn"
        and backward_fits(setup.dim + setup.emb_dim, score_for_target(target).means.shape[0])
    )


class _Evolve(torch.autograd.Function):
    """(theta; z0, seed, noise) -> (deltas, z_final) for CAIS_VAR.

    Forward: the fused rollout, storing the trajectory. Backward: the replay
    kernel on the cotangent of deltas. theta is eps, betas, vd_mean,
    vd_logdiag and the net's parameters (passed as inputs so that autograd
    routes their gradients; the net module itself rides in `call`); z0, seed
    and noise are data and z_final carries no gradient.
    """

    @staticmethod
    def forward(ctx, call, z0, seed, noise, eps, betas, vd_mean, vd_logdiag, *weights):
        z, deltas, traj = call["rollout"](
            z0, torch.zeros(z0.shape[0], dtype=z0.dtype, device=z0.device),
            betas.contiguous(), eps, vd_mean.contiguous(), vd_logdiag.contiguous(),
            call["score"], od.CAIS_VAR, seed=seed, noise=noise, return_trajectory=True,
            **call["static"],
        )
        ctx.call = call
        ctx.save_for_backward(traj, eps, betas, vd_mean, vd_logdiag)
        ctx.mark_non_differentiable(z)
        return deltas, z

    @staticmethod
    def backward(ctx, g_deltas, _g_z):
        call = ctx.call
        traj, eps, betas, vd_mean, vd_logdiag = ctx.saved_tensors
        g = call["backward"](
            traj, g_deltas.contiguous(), betas.contiguous(), eps, vd_mean.contiguous(),
            vd_logdiag.contiguous(), call["score"], od.CAIS_VAR, **call["static"],
        )
        g_weights = [g["sn"][name] for name, _ in call["static"]["sn"].named_parameters()]
        return (None, None, None, None, g["eps"].reshape(eps.shape), g["betas"],
                g["vd_mean"], g["vd_logdiag"], *g_weights)


def neg_elbos_fused(params, n_chains: int, ctx, setup: bounds.CMCDSetup, target,
                    *, generator=None, base_normals=None, noise=None,
                    rollout=evolve_overdamped_fused, backward=evolve_vargrad_bwd_replay):
    """Per-chain negative ELBOs through the fused rollout, differentiable in
    params through the fused backward (VarGrad semantics): (neg_elbos, z).

    base_normals (N, dim) / noise (K, N, dim): optional draws standing in
    for the generator's. rollout / backward: the kernels' wrappers, or their
    plain versions where the two are compared on the card.
    """
    if not supports_fused_train(setup, target):
        raise NotImplementedError(
            f"no fused training kernels for mode {setup.mode} on {target.name} "
            f"(nn {setup.nn_arch}, emb_dim {setup.emb_dim}); see ROADMAP queue B"
        )
    p = bounds.merged_params(params)
    vd, sn = p["vd"], p["sn"]
    dev = vd["mean"].device
    # Reparameterised draw: -log q(z0(theta)) carries the vd gradient through
    # plain autograd; the rollout sees z0 as data.
    z0 = diag_gaussian_sample(vd, n_chains, generator=generator, base_normals=base_normals)
    w0 = -diag_gaussian_log_prob(vd, z0)
    betas = betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])
    seed = torch.randint(2**31 - 1, (1,), generator=generator, device=dev)
    call = {
        "rollout": rollout, "backward": backward, "score": score_for_target(target, dev),
        "static": dict(dim=setup.dim, nbridges=setup.nbridges, sn=sn,
                       eps_schedule=setup.eps_schedule, grad_clipping=setup.grad_clipping),
    }
    deltas, z = _Evolve.apply(
        call, z0.detach().contiguous(), seed, noise, torch.as_tensor(p["eps"], device=dev),
        betas, vd["mean"], vd["logdiag"], *sn.parameters(),
    )
    w = w0 + deltas + ctx.target_log_prob(z.detach())
    return -w, z


def var_bound_fused(params, n_chains: int, ctx, setup: bounds.CMCDSetup, target, **draws):
    """VarGrad loss with the fused forward and backward: the contract of
    bounds.var_bound plus the target argument."""
    neg_elbos, z = neg_elbos_fused(params, n_chains, ctx, setup, target, **draws)
    return torch.clamp(torch.var(neg_elbos, correction=0), -1e7, 1e7), (neg_elbos, z)
