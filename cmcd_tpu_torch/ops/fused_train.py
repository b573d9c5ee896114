"""The fused training losses: kernel forward, kernel backward
(cmcd_tpu/ops/fused_train.py: _make_evolve, neg_elbos_pallas,
var_bound_pallas; _make_evolve_kl, _make_evolve_kl_ud, _make_evolve_kl_uha,
neg_elbos_pallas_kl, kl_bound_pallas).

var_bound_fused stands in for bounds.var_bound on MCD_CAIS_var_sn and
kl_bound_fused for bounds.kl_bound on the overdamped modes that keep the
state in the graph (OD_KL_FUSED_MODES: MCD_CAIS_sn, MCD_ULA_sn, MCD_ULA and
MCD_DNF, whose second net's parameters enter the Function beside the
first's), the
seven underdamped modes (UD_KL_FUSED_MODES; LDVI is MCD_U_a-lp-sn) and UHA:
the same (loss, (neg_elbos, z)) contract and the same math, but the K-step
rollout runs in a fused rollout kernel (ops/overdamped.py,
ops/underdamped.py, ops/uha.py) and the gradient in a backward kernel,
joined by a torch.autograd.Function.

Everything outside the bridge loop stays plain autograd, as in JAX: the
reparameterised initial term -log q(z0(theta)), the chain rule from
mgridref_y to betas, the final target term, the mean or the variance and its
clip. Only the summed per-step log-weight increments have the custom
backward.

VarGrad cuts the chain states and the final-state target term from the
graph, as its integrator does (integrators/overdamped.py, stop_grad_state),
so its gradient is a sum over independent points. backward="replay" stores
the rollout's trajectory and hands it to the replay kernel (ops/vargrad.py);
"reroll" stores nothing and lets the backward kernel roll the trajectory
again from (z0, seed); "auto" replays unless the stored trajectory,
(K + 1) * N * dim * 4 bytes, would exceed _REPLAY_BYTES_BUDGET.

KL cuts nothing: z0 and z_final carry real cotangents. The rollout stores
trajectory and noise (the underdamped and UHA ones also the momenta),
autograd gives the final target term's gradient in z_final, and the
reverse-sweep kernel (ops/kl.py, ops/kl_underdamped.py, ops/kl_uha.py) chains
it back through every step to theta and to z0, from where autograd goes on
through the reparameterised draw. The underdamped sweep also returns gamma's
gradient and eta's (one of the two is zero: the exact refresh reads eta and
not gamma, the others gamma and not eta; the JAX package gives zeros too);
the UHA sweep returns eta's and md's (md is not trained: the
trainable set never names it, as in the JAX package).

A net past _NET_GRADS_OUTSIDE_BYTES (the 1600-D LGCP's: 31.4 MB) takes the
split form of the KL sweep, as the JAX package does: MCD_CAIS_sn through
the wide rollout (ops/overdamped_wide.py) and the split sweep
(ops/kl_split.py), whose weight gradients come from one batched pass
outside the kernel.

On CPU tensors the Functions run the plain versions; on CUDA tensors they
launch the kernels or raise. plain=True runs the plain versions wherever the
tensors lie: the card's check of a whole step through the kernels against the
same step without them.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from cmcd_tpu_torch import bounds
from cmcd_tpu_torch.distributions import diag_gaussian_log_prob, diag_gaussian_sample
from cmcd_tpu_torch.integrators import OVERDAMPED, UNDERDAMPED
from cmcd_tpu_torch.integrators import overdamped as od
from cmcd_tpu_torch.ops import kl, kl_underdamped, nets, overdamped_wide, uha, vargrad
from cmcd_tpu_torch.ops.fused import (
    PIS_ARCHS,
    WIDE_MODES,
    kernel_nets,
    net_width,
    supports_fused,
)
from cmcd_tpu_torch.ops.kl import evolve_kl_bwd, evolve_kl_bwd_plain
from cmcd_tpu_torch.ops.kl_split import evolve_kl_split, evolve_kl_split_plain
from cmcd_tpu_torch.ops.kl_uha import evolve_kl_bwd_uha, evolve_kl_bwd_uha_plain
from cmcd_tpu_torch.ops.kl_underdamped import (
    evolve_kl_bwd_underdamped,
    evolve_kl_bwd_underdamped_plain,
)
from cmcd_tpu_torch.ops.overdamped import evolve_overdamped_fused, evolve_overdamped_fused_plain
from cmcd_tpu_torch.ops.overdamped_wide import (
    evolve_overdamped_wide,
    evolve_overdamped_wide_plain,
)
from cmcd_tpu_torch.ops.target_grads import n_target_floats, score_for_target
from cmcd_tpu_torch.ops.underdamped import (
    evolve_underdamped_fused,
    evolve_underdamped_fused_plain,
)
from cmcd_tpu_torch.ops.vargrad import (
    evolve_vargrad_bwd_replay,
    evolve_vargrad_bwd_replay_plain,
    evolve_vargrad_bwd_reroll,
    evolve_vargrad_bwd_reroll_plain,
)
from cmcd_tpu_torch.schedules import betas_from_grid

# The overdamped modes whose KL loss has a fused backward: the sweep's four
# forms (ops/kl.SWEEP_SPECS), on every target of the overdamped kernels (the
# funnel included; DNF with geffner nets only, and not on the LGCP).
OD_KL_FUSED_MODES = frozenset({"MCD_CAIS_sn", "MCD_ULA_sn", "MCD_ULA", "MCD_DNF"})
# The underdamped modes whose KL loss has a fused backward: all seven (B7's
# kernel covers every refresh and CAIS_UHA's forward net), on the targets of
# ops/underdamped.UD_TARGETS.
UD_KL_FUSED_MODES = frozenset(UNDERDAMPED)
# UHA: the UHA rollout (B8) and its sweep (B9).
UHA_KL_FUSED_MODES = frozenset({"UHA"})

# The stored trajectory costs (K + 1) * N * dim * 4 bytes between the forward
# and the backward kernel; past this budget "auto" takes the re-rolling
# backward, which stores nothing.
_REPLAY_BYTES_BUDGET = 256 * 1024 * 1024

# The score net's bytes past which the KL backward takes the split sweep
# (cmcd_tpu/ops/fused_train.py, same name and size): the weights' gradients
# leave the kernel for one batched pass. The port's tile sweeps take nets
# up to 160 features (~0.2 MB); the LGCP's geffner net is 31.4 MB.
_NET_GRADS_OUTSIDE_BYTES = 4 * 1024 * 1024


def net_bytes(setup: bounds.CMCDSetup) -> int:
    """Bytes of the geffner net's parameters in the mode's setup (0 for a
    PIS net, which the split sweep does not take): nlayers square layers of
    dim + emb_dim features with biases, the head, the embedding table and
    factor_sn, in f32."""
    if setup.nn_arch != "geffner":
        return 0
    f = setup.dim + setup.emb_dim
    return 4 * (setup.nlayers * (f * f + f) + setup.dim * (f + 1)
                + setup.nbridges * setup.emb_dim + 1)


def uses_split_sweep(setup: bounds.CMCDSetup) -> bool:
    """True if the KL loss of `setup` takes the wide rollout and the split
    sweep: the CAIS carry (WIDE_MODES) with a net past
    _NET_GRADS_OUTSIDE_BYTES."""
    return setup.mode in WIDE_MODES and net_bytes(setup) > _NET_GRADS_OUTSIDE_BYTES


def supports_fused_train(setup: bounds.CMCDSetup, target) -> bool:
    """True if a fused training loss can run: what supports_fused asks of
    the rollout, the VarGrad mode or a mode of KL_FUSED_MODES, and a net that
    also fits one block of that mode's backward kernel (a PIS net with its
    gate sums; a mode without a net, ULA or UHA: its sweep takes whatever
    its rollout takes)."""
    if not supports_fused(setup, target):
        return False
    if setup.mode == "MCD_CAIS_var_sn":
        fits = vargrad.kernel_fits
    elif setup.mode in KL_FUSED_MODES:
        fits = _kl_family(setup).fits
    else:
        return False
    width = net_width(setup)
    gate = {"gate": setup.dim} if setup.nn_arch in PIS_ARCHS else {}
    return (fits is None or width == 0
            or fits(width, n_target_floats(score_for_target(target)), dim=setup.dim, **gate,
                    **kernel_nets(setup)))


def choose_backward(backward: str, setup: bounds.CMCDSetup, n_chains: int) -> str:
    """"replay" or "reroll" for the VarGrad loss: `backward` itself, or for
    "auto" the replay unless its trajectory would pass _REPLAY_BYTES_BUDGET."""
    if backward not in ("auto", "replay", "reroll"):
        raise ValueError(f"backward must be auto, replay or reroll, got {backward!r}")
    if backward != "auto":
        return backward
    traj_bytes = (setup.nbridges + 1) * n_chains * setup.dim * 4
    return "replay" if traj_bytes <= _REPLAY_BYTES_BUDGET else "reroll"


def _net_inputs(p, nbridges):
    """(names, tensors) of the score nets' inputs to a Function
    (ops/nets.function_inputs of "sn" and, for MCD_DNF, "sn2"; none without
    a net): each name a (net key, input name) pair."""
    names, tensors = [], []
    for key in ("sn", "sn2"):
        if p.get(key) is not None:
            n, t = nets.function_inputs(p[key], nbridges)
            names += [(key, name) for name in n]
            tensors += t
    return names, tensors


def _theta_grads(call, g, eps):
    """A backward kernel's gradient dict in the order of the Functions' theta
    inputs: eps, betas, vd_mean, vd_logdiag, the nets' inputs (call["net"]:
    geffner's parameters, a PIS net's kernel view; sn2's after sn's)."""
    g_weights = [g[key][name] for key, name in call["net"]]
    return (g["eps"].reshape(eps.shape), g["betas"], g["vd_mean"], g["vd_logdiag"], *g_weights)


class _Evolve(torch.autograd.Function):
    """(theta; z0, seed, noise) -> (deltas, z_final) for CAIS_VAR.

    Forward: the fused rollout, storing the trajectory if call["replay"].
    Backward: the replay kernel on the stored trajectory, or the re-rolling
    kernel on (z0, seed, noise), with the cotangent of deltas. theta is eps,
    betas, vd_mean, vd_logdiag and the net's inputs (geffner's parameters,
    or a PIS net's kernel view formed from its parameters: passed as inputs
    so that autograd routes their gradients; the net module itself rides in
    `call`); z0, seed and noise are data and z_final carries no gradient.
    """

    @staticmethod
    def forward(ctx, call, z0, seed, noise, eps, betas, vd_mean, vd_logdiag, *weights):
        z, deltas, *traj = call["rollout"](
            z0, torch.zeros(z0.shape[0], dtype=z0.dtype, device=z0.device),
            betas.contiguous(), eps, vd_mean.contiguous(), vd_logdiag.contiguous(),
            call["score"], od.CAIS_VAR, seed=seed, noise=noise,
            return_trajectory=call["replay"], **call["static"],
        )
        ctx.call = call
        ctx.draws = (seed, noise)
        ctx.save_for_backward(traj[0] if call["replay"] else z0, eps, betas, vd_mean, vd_logdiag)
        ctx.mark_non_differentiable(z)
        return deltas, z

    @staticmethod
    def backward(ctx, g_deltas, _g_z):
        call = ctx.call
        start, eps, betas, vd_mean, vd_logdiag = ctx.saved_tensors
        draws = {} if call["replay"] else dict(zip(("seed", "noise"), ctx.draws))
        g = call["backward"](
            start, g_deltas.contiguous(), betas.contiguous(), eps, vd_mean.contiguous(),
            vd_logdiag.contiguous(), call["score"], od.CAIS_VAR, **draws, **call["static"],
        )
        return (None, None, None, None, *_theta_grads(call, g, eps))


class _EvolveKL(torch.autograd.Function):
    """(theta, z0; seed, noise) -> (deltas, z_final) for an overdamped spec
    of the sweep (CAIS, ULA_SN, ULA: call["spec"]), nothing cut.

    Forward: the fused rollout, storing trajectory and noise. Backward: the
    reverse-sweep kernel with the cotangents of deltas and of z_final;
    returns the gradients of theta (as _Evolve) and of z0.
    """

    @staticmethod
    def forward(ctx, call, z0, seed, noise, eps, betas, vd_mean, vd_logdiag, *weights):
        z, deltas, traj, draws = call["rollout"](
            z0, torch.zeros(z0.shape[0], dtype=z0.dtype, device=z0.device),
            betas.contiguous(), eps, vd_mean.contiguous(), vd_logdiag.contiguous(),
            call["score"], call["spec"], seed=seed, noise=noise, return_trajectory=True,
            return_noise=True, **call["static"],
        )
        ctx.call = call
        ctx.save_for_backward(traj, draws, eps, betas, vd_mean, vd_logdiag)
        return deltas, z

    @staticmethod
    def backward(ctx, g_deltas, g_z):
        call = ctx.call
        traj, draws, eps, betas, vd_mean, vd_logdiag = ctx.saved_tensors
        # The split sweep returns the net-output cotangents third.
        g, g_z0, *_ = call["backward"](
            traj, draws, g_deltas.contiguous(), g_z.contiguous(), betas.contiguous(), eps,
            vd_mean.contiguous(), vd_logdiag.contiguous(), call["score"], call["spec"],
            **call["static"],
        )
        return (None, g_z0, None, None, *_theta_grads(call, g, eps))


class _EvolveKLUD(torch.autograd.Function):
    """(theta, z0; seed, noise) -> (deltas, z_final) for an underdamped mode,
    nothing cut.

    Forward: the fused underdamped rollout, storing positions, momenta and
    draws. Backward: the underdamped reverse-sweep kernel with the cotangents
    of deltas and of z_final; returns the gradients of theta (eps, gamma,
    eta, betas, vd_mean, vd_logdiag, the net's parameters if the mode has a
    net) and of z0.
    """

    @staticmethod
    def forward(ctx, call, z0, seed, noise, eps, gamma, eta, betas, vd_mean, vd_logdiag,
                *weights):
        z, deltas, ztraj, rtraj, draws = call["rollout"](
            z0, torch.zeros(z0.shape[0], dtype=z0.dtype, device=z0.device),
            betas.contiguous(), eps, gamma, eta, vd_mean.contiguous(), vd_logdiag.contiguous(),
            call["score"], call["spec"], seed=seed, noise=noise, return_state=True,
            **call["static"],
        )
        ctx.call = call
        ctx.save_for_backward(ztraj, rtraj, draws, eps, gamma, eta, betas, vd_mean, vd_logdiag)
        return deltas, z

    @staticmethod
    def backward(ctx, g_deltas, g_z):
        call = ctx.call
        ztraj, rtraj, draws, eps, gamma, eta, betas, vd_mean, vd_logdiag = ctx.saved_tensors
        g, g_z0 = call["backward"](
            ztraj, rtraj, draws, g_deltas.contiguous(), g_z.contiguous(), betas.contiguous(),
            eps, gamma, eta, vd_mean.contiguous(), vd_logdiag.contiguous(), call["score"],
            call["spec"], **call["static"],
        )
        g_eps, g_betas, g_mu, g_ld, *g_weights = _theta_grads(call, g, eps)
        return (None, g_z0, None, None, g_eps, g["gamma"].reshape(gamma.shape),
                g["eta"].reshape(eta.shape), g_betas, g_mu, g_ld, *g_weights)


class _EvolveKLUHA(torch.autograd.Function):
    """(theta, z0; seed, noise) -> (deltas, z_final) for UHA, nothing cut.

    Forward: the fused UHA rollout, storing positions, momenta and draws.
    Backward: the UHA reverse-sweep kernel with the cotangents of deltas and
    of z_final; returns the gradients of theta (eps, eta, md, betas,
    vd_mean, vd_logdiag) and of z0.
    """

    @staticmethod
    def forward(ctx, call, z0, seed, noise, eps, eta, md, betas, vd_mean, vd_logdiag):
        z, deltas, ztraj, rtraj, draws = call["rollout"](
            z0, betas.contiguous(), eps, eta, md.contiguous(), vd_mean.contiguous(),
            vd_logdiag.contiguous(), call["score"], seed=seed, noise=noise, return_state=True,
            **call["static"],
        )
        ctx.call = call
        ctx.save_for_backward(ztraj, rtraj, draws, eps, eta, md, betas, vd_mean, vd_logdiag)
        return deltas, z

    @staticmethod
    def backward(ctx, g_deltas, g_z):
        call = ctx.call
        ztraj, rtraj, draws, eps, eta, md, betas, vd_mean, vd_logdiag = ctx.saved_tensors
        g, g_z0 = call["backward"](
            ztraj, rtraj, draws, g_deltas.contiguous(), g_z.contiguous(), betas.contiguous(),
            eps, eta, md.contiguous(), vd_mean.contiguous(), vd_logdiag.contiguous(),
            call["score"], **call["static"],
        )
        return (None, g_z0, None, None, g["eps"].reshape(eps.shape), g["eta"].reshape(eta.shape),
                g["md"], g["betas"], g["vd_mean"], g["vd_logdiag"])


def _overdamped_static(setup, p):
    """The overdamped wrappers' fixed keywords (sn2 only for MCD_DNF, the
    only mode whose wrappers take it)."""
    return dict(dim=setup.dim, nbridges=setup.nbridges, sn=p.get("sn"),
                eps_schedule=setup.eps_schedule, grad_clipping=setup.grad_clipping,
                **({"sn2": p["sn2"]} if "sn2" in p else {}))


class _KLFamily(NamedTuple):
    """One family of KL_FUSED_MODES: its rollout and its sweep, each as
    (kernel wrapper, plain version); the Function joining them; the leaves
    of the merged params it takes before betas; the rollout's fixed keyword
    arguments; the backward kernel's kernel_fits (None: no net, the sweep
    takes what the rollout takes); and the words fused_training_path prints."""

    modes: frozenset
    rollout: tuple
    sweep: tuple
    function: type
    leaves: tuple
    static: Callable
    fits: Callable | None
    words: str


def _kl_families() -> tuple:
    """The rows, built at the call so that each names the wrappers the
    modules hold then."""
    return (
        _KLFamily(
            OD_KL_FUSED_MODES,
            (evolve_overdamped_fused, evolve_overdamped_fused_plain),
            (evolve_kl_bwd, evolve_kl_bwd_plain),
            _EvolveKL, ("eps",), _overdamped_static, kl.kernel_fits, "KL reverse sweep",
        ),
        _KLFamily(
            UD_KL_FUSED_MODES,
            (evolve_underdamped_fused, evolve_underdamped_fused_plain),
            (evolve_kl_bwd_underdamped, evolve_kl_bwd_underdamped_plain),
            _EvolveKLUD, ("eps", "gamma", "eta"),
            lambda setup, p: dict(dim=setup.dim, nbridges=setup.nbridges, sn=p.get("sn")),
            kl_underdamped.kernel_fits,
            "underdamped rollout and KL reverse sweep",
        ),
        _KLFamily(
            UHA_KL_FUSED_MODES,
            (uha.evolve_uha_fused, uha.evolve_uha_fused_plain),
            (evolve_kl_bwd_uha, evolve_kl_bwd_uha_plain),
            _EvolveKLUHA, ("eps", "eta", "md"),
            lambda setup, p: dict(dim=setup.dim, nbridges=setup.nbridges, lfsteps=setup.lfsteps),
            None, "UHA rollout and UHA reverse sweep",
        ),
    )


def _split_family() -> _KLFamily:
    """The row of a net past _NET_GRADS_OUTSIDE_BYTES (uses_split_sweep)."""
    return _KLFamily(
        frozenset(WIDE_MODES),
        (evolve_overdamped_wide, evolve_overdamped_wide_plain),
        (evolve_kl_split, evolve_kl_split_plain),
        _EvolveKL, ("eps",), _overdamped_static, overdamped_wide.kernel_fits,
        "wide rollout and split KL reverse sweep (B12)",
    )


# The modes whose KL loss has a fused backward.
KL_FUSED_MODES = frozenset().union(*(f.modes for f in _kl_families()))


def _kl_family(setup: bounds.CMCDSetup) -> _KLFamily:
    if uses_split_sweep(setup):
        return _split_family()
    return next(f for f in _kl_families() if setup.mode in f.modes)


def _prepare(params, n_chains, setup, target, generator, base_normals):
    """What both losses do before the rollout: (p, z0, w0, betas, seed, score)."""
    if not supports_fused_train(setup, target):
        raise NotImplementedError(
            f"no fused training kernels for mode {setup.mode} on {target.name} "
            f"(nn {setup.nn_arch}, emb_dim {setup.emb_dim}, units "
            f"{list(setup.fully_connected_units)}); see ROADMAP queue B"
        )
    p = bounds.merged_params(params)
    vd = p["vd"]
    dev = vd["mean"].device
    # Reparameterised draw: -log q(z0(theta)) carries the vd gradient through
    # plain autograd.
    z0 = diag_gaussian_sample(vd, n_chains, generator=generator, base_normals=base_normals)
    w0 = -diag_gaussian_log_prob(vd, z0)
    betas = betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])
    seed = torch.randint(2**31 - 1, (1,), generator=generator, device=dev)
    return p, z0, w0, betas, seed, score_for_target(target, dev)


def neg_elbos_fused(params, n_chains: int, ctx, setup: bounds.CMCDSetup, target,
                    *, generator=None, base_normals=None, noise=None,
                    backward: str = "auto", plain: bool = False):
    """Per-chain negative ELBOs through the fused rollout, differentiable in
    params through a fused backward (VarGrad semantics): (neg_elbos, z).

    base_normals (N, dim) / noise (K, N, dim): optional draws standing in
    for the generator's. backward: "auto", "replay" or "reroll" (the module
    docstring). plain: the plain versions instead of the kernels' wrappers.
    """
    if setup.mode != "MCD_CAIS_var_sn":
        raise NotImplementedError(f"the fused VarGrad loss is for MCD_CAIS_var_sn, not {setup.mode}")
    p, z0, w0, betas, seed, score = _prepare(
        params, n_chains, setup, target, generator, base_normals)
    replay = choose_backward(backward, setup, n_chains) == "replay"
    wrappers = ((evolve_vargrad_bwd_replay, evolve_vargrad_bwd_replay_plain) if replay
                else (evolve_vargrad_bwd_reroll, evolve_vargrad_bwd_reroll_plain))
    names, weights = _net_inputs(p, setup.nbridges)
    call = {
        "rollout": (evolve_overdamped_fused, evolve_overdamped_fused_plain)[plain],
        "backward": wrappers[plain],
        "replay": replay,
        "score": score,
        "static": _overdamped_static(setup, p),
        "net": names,
    }
    vd = p["vd"]
    # The rollout sees z0 as data.
    deltas, z = _Evolve.apply(
        call, z0.detach().contiguous(), seed, noise,
        torch.as_tensor(p["eps"], device=z0.device), betas, vd["mean"], vd["logdiag"], *weights,
    )
    w = w0 + deltas + ctx.target_log_prob(z.detach())
    return -w, z


def var_bound_fused(params, n_chains: int, ctx, setup: bounds.CMCDSetup, target, **draws):
    """VarGrad loss with the fused forward and backward: the contract of
    bounds.var_bound plus the target argument."""
    neg_elbos, z = neg_elbos_fused(params, n_chains, ctx, setup, target, **draws)
    return torch.clamp(torch.var(neg_elbos, correction=0), -1e7, 1e7), (neg_elbos, z)


def neg_elbos_fused_kl(params, n_chains: int, ctx, setup: bounds.CMCDSetup, target,
                       *, generator=None, base_normals=None, noise=None, plain: bool = False):
    """Per-chain negative ELBOs through the fused rollout, differentiable in
    params through the reverse-sweep kernel (full backprop through time: the
    state cotangent chains through every step, the final target term and the
    reparameterised initial draw): (neg_elbos, z).

    The draws and plain as in neg_elbos_fused; the noise of an underdamped
    mode or UHA is (K + 1, N, dim), row 0 the initial momentum.
    """
    if setup.mode not in KL_FUSED_MODES:
        raise NotImplementedError(
            f"the fused KL loss implements {sorted(KL_FUSED_MODES)}, not {setup.mode}; "
            "see ROADMAP queue B"
        )
    family = _kl_family(setup)
    p, z0, w0, betas, seed, score = _prepare(params, n_chains, setup, target, generator,
                                             base_normals)
    names, weights = _net_inputs(p, setup.nbridges)
    call = {
        "rollout": family.rollout[plain],
        "backward": family.sweep[plain],
        "score": score,
        "static": family.static(setup, p),
        "spec": {**OVERDAMPED, **UNDERDAMPED}.get(setup.mode),
        "net": names,
    }
    vd = p["vd"]
    leaves = (torch.as_tensor(p[name], device=z0.device) for name in family.leaves)
    deltas, z = family.function.apply(
        call, z0.contiguous(), seed, noise, *leaves, betas, vd["mean"], vd["logdiag"], *weights,
    )
    # The floored eager log-prob: its gradient in z is the sweep's g_zfinal.
    w = w0 + deltas + ctx.target_log_prob(z)
    return -w, z


def kl_bound_fused(params, n_chains: int, ctx, setup: bounds.CMCDSetup, target, **draws):
    """KL loss (mean negative ELBO) with the fused forward and backward: the
    contract of bounds.kl_bound plus the target argument."""
    neg_elbos, z = neg_elbos_fused_kl(params, n_chains, ctx, setup, target, **draws)
    return torch.mean(neg_elbos), (neg_elbos, z)


def fused_training_path(setup: bounds.CMCDSetup, n_chains: int) -> tuple:
    """(loss, what it runs) for training `setup` on batches of n_chains: the
    fused loss of the mode (the rule of bounds.loss_fn_for_mode) with the
    VarGrad backward settled here, once, and that choice in words."""
    if "var" in setup.mode:
        backward = choose_backward("auto", setup, n_chains)
        return (functools.partial(var_bound_fused, backward=backward),
                f"var_bound_fused, VarGrad {backward} backward")
    if setup.mode not in KL_FUSED_MODES:
        raise NotImplementedError(f"no fused training loss for {setup.mode}")
    return kl_bound_fused, f"kl_bound_fused, {_kl_family(setup).words}"
