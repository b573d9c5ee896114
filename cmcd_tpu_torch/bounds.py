"""Bounding machines: parameter initialisation and the ELBO / VarGrad values
(cmcd_tpu/bounds.py).

Parameters live in a dict {"train": {...}, "notrain": {...}}; the frozen
subtree is detached at loss time where JAX applies stop_gradient. The score
net is a module under params["train"]["sn"]: a GeffnerNet, or a PISNet /
PISGradNet (nn_arch "dds" / "dds_grad"); MCD_DNF has a second, state-only
net of the same arch under params["train"]["sn2"]. The losses build an
autograd graph where JAX differentiates: torch.autograd of var_bound is the
oracle the fused training loss (ops/fused_train.py) is held against.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from cmcd_tpu_torch import integrators
from cmcd_tpu_torch.distributions import (
    diag_gaussian_init,
    diag_gaussian_log_prob,
    diag_gaussian_sample,
    momentum_init,
)
from cmcd_tpu_torch.integrators.base import IntegratorContext
from cmcd_tpu_torch.networks import build_score_network
from cmcd_tpu_torch.schedules import betas_from_grid, make_beta_grid_params
from cmcd_tpu_torch.utils.device import resolve_device

# Modes that thread the eps schedule through (as in cmcd_tpu/bounds.py).
_EPS_SCHEDULE_MODES = ("MCD_CAIS_sn", "MCD_CAIS_var_sn")


@dataclasses.dataclass(frozen=True)
class CMCDSetup:
    """Static configuration of a bound."""

    mode: str
    dim: int
    nbridges: int
    eps_schedule: str = ""
    grad_clipping: bool = False
    emb_dim: int = 20
    nlayers: int = 2
    nn_arch: str = "geffner"
    fully_connected_units: tuple = (64, 64)  # the PIS nets' widths
    lfsteps: int = 1

    def __post_init__(self):
        if self.eps_schedule and self.mode not in _EPS_SCHEDULE_MODES:
            object.__setattr__(self, "eps_schedule", "")

    def context(self, target_log_prob: Callable, apply_sn=None, apply_sn2=None):
        return IntegratorContext(
            target_log_prob=target_log_prob,
            nbridges=self.nbridges,
            dim=self.dim,
            apply_sn=apply_sn,
            apply_sn2=apply_sn2,
            eps_schedule=self.eps_schedule,
            grad_clipping=self.grad_clipping,
            lfsteps=self.lfsteps,
        )


def default_trainable(mode: str, train_eps=True, train_vi=True, train_betas=True):
    """Trainable-set logic of cmcd_tpu/bounds.py::default_trainable."""
    trainable = ("eta",) if mode == "UHA" else ("eta", "gamma")
    if train_eps:
        trainable = trainable + ("eps",)
    if train_vi:
        trainable = trainable + ("vd",)
    if train_betas:
        trainable = trainable + ("mgridref_y",)
    return trainable


def initialize(
    setup: CMCDSetup,
    target_log_prob: Callable,
    vdparams=None,
    eps: float = 0.01,
    gamma: float = 10.0,
    eta: float = 0.5,
    ngridb: int = 32,
    mgridref_y=None,
    trainable=("eps",),
    init_sigma: float = 1.0,
    seed: int = 1,
    device=None,
):
    """Build the parameter dict and the evolve context: (params, ctx).

    device=None is the card (utils/device.resolve_device). The net is
    initialised from torch.Generator().manual_seed(seed), MCD_DNF's second
    net from seed + 1 (JAX: PRNGKey(seed + 1)); their bits differ from JAX's
    (compare through utils/convert.py).
    """
    integrators.check_mode(setup.mode)
    device = resolve_device(device)
    train: dict[str, Any] = {}
    notrain: dict[str, Any] = {}

    def place(name, value):
        (train if name in trainable else notrain)[name] = value

    place("vd", vdparams if vdparams is not None
          else diag_gaussian_init(setup.dim, init_sigma, device=device))
    place("eps", torch.tensor(eps, dtype=torch.float32, device=device))
    place("gamma", torch.tensor(gamma, dtype=torch.float32, device=device))
    place("eta", torch.tensor(eta, dtype=torch.float32, device=device))

    apply_sn = apply_sn2 = None
    if integrators.mode_uses_score_network(setup.mode):
        def net(net_seed, rho_dim):
            return build_score_network(
                setup.dim, setup.emb_dim, setup.nbridges, nlayers=setup.nlayers,
                arch=setup.nn_arch, device=device, rho_dim=rho_dim,
                generator=torch.Generator(device=device).manual_seed(net_seed),
                fully_connected_units=list(setup.fully_connected_units),
                target_log_prob=target_log_prob,
            )

        train["sn"], apply_sn = net(seed, integrators.mode_sn_rho_dim(setup.mode, setup.dim))
        if setup.mode == "MCD_DNF":  # the backward mean's own net, state only
            train["sn2"], apply_sn2 = net(seed + 1, 0)

    if setup.mode == "UHA":
        # default_trainable never names md: it stays where it starts.
        place("md", momentum_init(setup.dim, device))

    mg, gridref_x, target_x = make_beta_grid_params(
        setup.nbridges, ngridb, mgridref_y, device=device
    )
    place("mgridref_y", mg)
    notrain["gridref_x"] = gridref_x
    notrain["target_x"] = target_x

    params = {"train": train, "notrain": notrain}
    return params, setup.context(target_log_prob, apply_sn, apply_sn2)


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


def merged_params(params):
    """train + detach(notrain), one flat dict."""
    return {**params["train"], **_detach(params["notrain"])}


def compute_elbos(params, n_chains: int, ctx: IntegratorContext, setup: CMCDSetup,
                  *, generator=None, base_normals=None, noise=None):
    """Per-chain negative ELBOs and final states: (neg_elbos (N,), z (N, dim)).

    neg_elbo = -w with w = -log q(z_1) + sum_k [log B_k - log F_k] + log pi(z_K).
    base_normals / noise: optional draws standing in for `generator`'s.
    """
    p = merged_params(params)
    z = diag_gaussian_sample(p["vd"], n_chains, generator=generator,
                             base_normals=base_normals)
    w = -diag_gaussian_log_prob(p["vd"], z)

    if setup.nbridges >= 1:
        betas = betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])
        z, w_delta, _ = integrators.evolve(
            z, betas, p, ctx, setup.mode, noise=noise, generator=generator
        )
        w = w + w_delta

    w = w + ctx.target_log_prob(z)
    return -w, z


def kl_bound(params, n_chains: int, ctx, setup, **draws):
    """Mean negative ELBO (the KL training loss). Exact under autograd at
    any nbridges: the eager target score stays differentiable in the state
    (integrators/base.target_grad), so the gradient is the full backprop
    through time that jax.grad of the scan loss gives. Every underdamped mode
    trains on it (no "var" in their names); in the approximate-refresh modes
    eta is unused and gets no gradient (JAX: zeros)."""
    neg_elbos, z = compute_elbos(params, n_chains, ctx, setup, **draws)
    return torch.mean(neg_elbos), (neg_elbos, z)


def var_bound(params, n_chains: int, ctx, setup, **draws):
    """VarGrad loss: clipped population variance (ddof 0, as JAX) of the
    negative ELBOs."""
    neg_elbos, z = compute_elbos(params, n_chains, ctx, setup, **draws)
    return torch.clamp(torch.var(neg_elbos, correction=0), -1e7, 1e7), (neg_elbos, z)


def loss_fn_for_mode(mode: str):
    """VarGrad for the "var" modes, the KL bound otherwise."""
    return var_bound if "var" in mode else kl_bound
