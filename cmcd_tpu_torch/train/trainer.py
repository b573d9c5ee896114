"""Training loop: elementwise clip(5.0) then Adam, parameter projection,
EMA, NaN guard (cmcd_tpu/train/trainer.py).

PyTorch idiom inside: the trainable tree holds tensors and the score net as
a GeffnerNet; `train` works on its own copy of it, updates that copy in
place under no_grad, and one explicit torch.Generator on the parameters'
device feeds every draw. A step makes no host synchronisation: the loss
stays on the device and is read only at the logging, callback and NaN-check
cadences, which are evaluated per chunk of `steps_per_call` steps as in the
JAX trainer (there a chunk is one jitted scan; here it only sets the cadence
of the host checks).
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
import warnings
from typing import Any, Callable, Optional

import torch
from torch import nn

from cmcd_tpu_torch import bounds
from cmcd_tpu_torch.utils.device import resolve_device


def tree_leaves(tree) -> list:
    """The tensors of a parameter tree (dicts, tensors, nn.Modules), in a
    fixed order: dict keys sorted, a module's parameters in its own order."""
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_leaf_names(tree, prefix: str = "") -> list:
    """A name for each tensor of tree_leaves(tree), in its order: the dict
    keys and a module's parameter names, joined by dots."""
    if isinstance(tree, nn.Module):
        return [prefix + name for name, _ in tree.named_parameters()]
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in tree_leaf_names(tree[k], f"{prefix}{k}.")]
    return [prefix.rstrip(".")]


def _copy_tree(tree):
    if isinstance(tree, nn.Module):
        return copy.deepcopy(tree)
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


def double_tree(tree):
    """A detached float64 copy of a parameter tree, the net module included:
    the reference that arbitrates between two float32 paths."""
    if isinstance(tree, nn.Module):
        return copy.deepcopy(tree).double()
    if isinstance(tree, dict):
        return {k: double_tree(v) for k, v in tree.items()}
    return tree.detach().double()


def _finite_check(losses, leaves) -> torch.Tensor:
    """No loss is NaN and every parameter is finite, as one device scalar.

    Losses are checked for NaN, not for finiteness: many_gmm's log-prob floor
    (-1e4 -> -inf) makes the loss value +-inf whenever a chain sits in the
    floored region while its gradient stays finite, and such runs must train
    through. Parameters are checked for finiteness: a non-finite leaf means
    the update itself blew up."""
    ok = ~torch.isnan(losses).any()
    for x in leaves:
        ok = ok & torch.isfinite(x).all()
    return ok


@torch.no_grad()
def project(train_params: dict, trainable=None) -> dict:
    """Constraint projection after each update: eps in [1e-7, 0.5], eta in
    [0, 0.99], gamma >= 1e-3, mgridref_y >= 1e-3. Returns a new dict whose
    other entries are the input's own."""
    out = dict(train_params)
    if "eps" in out:
        out["eps"] = torch.clamp(out["eps"], 0.0000001, 0.5)
    if "eta" in out:
        out["eta"] = torch.clamp(out["eta"], 0.0, 0.99)
    if "gamma" in out:
        out["gamma"] = torch.clamp(out["gamma"], min=0.001)
    if "mgridref_y" in out:
        out["mgridref_y"] = torch.relu(out["mgridref_y"] - 0.001) + 0.001
    return out


class ClipAdam:
    """Each gradient element clipped to +-5, then Adam: the counterpart of
    optax.chain(optax.clip(5.0), optax.adam(...)). (A norm clip such as
    clip_grad_norm_ is a different optimizer.) A leaf whose gradient is None
    is left as it is, which is what Adam does with JAX's zero gradient."""

    def __init__(self, leaves, step_size, b1=0.9, b2=0.999, eps=1e-8, clip=5.0):
        self.leaves = list(leaves)
        self.clip = clip
        self.adam = torch.optim.Adam(self.leaves, lr=step_size, betas=(b1, b2), eps=eps)

    @torch.no_grad()
    def step(self, grads):
        for leaf, g in zip(self.leaves, grads):
            leaf.grad = None if g is None else torch.clamp(g, -self.clip, self.clip)
        self.adam.step()
        for leaf in self.leaves:
            leaf.grad = None


def create_optimizer(leaves, step_size, b1=0.9, b2=0.999, eps=1e-8) -> ClipAdam:
    """clip(5.0) then Adam over `leaves` (a list of tensors updated in place)."""
    return ClipAdam(leaves, step_size, b1, b2, eps)


@dataclasses.dataclass
class TrainResult:
    params: Any
    ema_params: Optional[Any]
    losses: Any          # (num_logged,) CPU tensor of logged losses
    diverged: bool
    steps_done: int
    # Ring of the last `track_last_losses` per-iteration losses, on the
    # parameters' device (None if not tracked); NaN where never written.
    last_losses: Optional[Any] = None


def train(
    setup: bounds.CMCDSetup,
    params,
    ctx,
    *,
    lr: float,
    iters: int,
    batch_size: int,
    generator=None,
    trainable,
    loss_fn: Optional[Callable] = None,
    use_ema: bool = False,
    ema_step_size: float = 0.001,
    callback: Optional[Callable] = None,
    callback_every: Optional[int] = None,
    nan_check_every: int = 100,
    log_every: Optional[int] = None,
    track_last_losses: int = 0,
    checkpoint=None,
    checkpoint_every: int = 0,
    resume: bool = False,
    profile_dir: str = "",
    steps_per_call: int = 0,
) -> TrainResult:
    """Run the optimizer loop on a copy of params["train"].

    loss_fn(params, batch_size, ctx, setup, generator=generator) ->
    (loss, (neg_elbos, z)); default bounds.loss_fn_for_mode(setup.mode).
    generator: the torch.Generator every draw comes from; default one seeded
    with 0 on the parameters' device.

    callback(step, info, z) is invoked every callback_every steps with host
    scalars (loss, grad_mean, var_loss, steps_per_sec, eps, gamma, eta). The NaN
    guard checks every nan_check_every steps and at the end, at chunk
    granularity, and stops early, returning the last parameters that passed
    it with steps_done set to the start of the failing chunk.

    steps_per_call: optimizer steps between host checks. 0 = the largest
    divisor of iters <= 100. It must divide iters. The z and neg_elbos
    handed to the callback come from the chunk's last step.

    Checkpointing, resume and profiling are not ported yet and raise if set.
    """
    if checkpoint is not None or checkpoint_every or resume or profile_dir:
        raise NotImplementedError(
            "train: checkpoint, resume and profile_dir are not ported yet; see ROADMAP"
        )
    loss_fn = loss_fn or bounds.loss_fn_for_mode(setup.mode)
    train_p = _copy_tree(params["train"])
    notrain = params["notrain"]
    leaves = tree_leaves(train_p)
    for leaf in leaves:
        leaf.requires_grad_(True)
    device = leaves[0].device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    optimizer = create_optimizer(leaves, lr)
    n_elements = sum(leaf.numel() for leaf in leaves)

    use_ring = track_last_losses > 0
    ring_size = max(track_last_losses, 1)
    ring = torch.full((ring_size,), math.nan, device=device) if use_ring else None
    ema = _copy_tree(train_p) if use_ema else None
    ema_leaves = tree_leaves(ema) if use_ema else None

    log_every = log_every or max(iters // 1000, 1)
    callback_every = callback_every or max(iters // 100, 1)

    if steps_per_call <= 0:
        span = max(iters, 1)
        steps_per_call = next(d for d in range(min(span, 100), 0, -1) if span % d == 0)
        if steps_per_call == 1 and span > 100:
            warnings.warn(
                f"auto steps_per_call degraded to 1 (iters={iters} has no divisor in "
                "[2, 100]): the host checks every step",
                stacklevel=2,
            )
    chunk = max(steps_per_call, 1)
    if iters % chunk != 0 and iters > 0:
        raise ValueError(
            f"steps_per_call={chunk} must divide iters={iters} (pass "
            f"steps_per_call=0 for a safe automatic choice)"
        )

    def snapshot():
        return [leaf.detach().clone() for leaf in leaves]

    def step(slot: int, want_grad_mean: bool):
        full = {"train": train_p, "notrain": notrain}
        loss, (neg_elbos, z) = loss_fn(full, batch_size, ctx, setup, generator=generator)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        optimizer.step(grads)
        with torch.no_grad():
            for key, value in project(train_p, trainable).items():
                if value is not train_p[key]:
                    train_p[key].copy_(value)
            if use_ema:
                for e, leaf in zip(ema_leaves, leaves):
                    e.mul_(1.0 - ema_step_size).add_(leaf, alpha=ema_step_size)
            if use_ring:
                ring[slot] = loss.detach()
            grad_mean = None
            if want_grad_mean:
                grad_mean = sum(g.sum() for g in grads if g is not None) / n_elements
        return loss.detach(), grad_mean, neg_elbos.detach(), z.detach()

    def fires(every, i0):
        return [i for i in range(i0, i0 + chunk) if i % every == 0]

    losses = []
    diverged = False
    last_finite = snapshot()
    steps_done = 0
    # Steps per second between host reads of a chunk's losses (the read waits
    # for the device); 0.0 until one clean delta between two reads exists.
    rate_t, rate_iter, chunk_rate = time.time(), 0, 0.0

    for i0 in range(0, iters, chunk):
        callback_steps = fires(callback_every, i0) if callback is not None else []
        c_losses = torch.empty(chunk, device=device)
        c_gms = {}
        for t in range(chunk):
            loss, grad_mean, neg_elbos, z = step(
                (i0 + t) % ring_size, want_grad_mean=(i0 + t) in callback_steps
            )
            c_losses[t] = loss
            if grad_mean is not None:
                c_gms[i0 + t] = grad_mean
        steps_done = i0 + chunk

        if fires(nan_check_every, i0) or steps_done == iters:
            # The parameters too, not only the losses: a loss is taken before
            # its update, so a blow-up at the chunk's last step leaves every
            # loss finite and the parameters it produced NaN.
            if not bool(_finite_check(c_losses, leaves)):
                diverged = True
                with torch.no_grad():
                    for leaf, good in zip(leaves, last_finite):
                        leaf.copy_(good)
                steps_done = i0
                break
            last_finite = snapshot()

        log_steps = fires(log_every, i0)
        if log_steps or callback_steps:
            c_losses_host = c_losses.cpu()
            now = time.time()
            if rate_iter > 0 and steps_done > rate_iter and now > rate_t:
                chunk_rate = (steps_done - rate_iter) / (now - rate_t)
            rate_t, rate_iter = now, steps_done
            losses += [float(c_losses_host[i - i0]) for i in log_steps]
            for i in callback_steps:
                merged = bounds.merged_params({"train": train_p, "notrain": notrain})
                info = {
                    "step": i,
                    "loss": float(c_losses_host[i - i0]),
                    "grad_mean": float(c_gms[i]),
                    "var_loss": float(torch.var(neg_elbos, correction=1)),
                    "steps_per_sec": chunk_rate,
                    "eps": float(merged["eps"].detach()),
                }
                for name in ("gamma", "eta"):
                    if name in merged:
                        info[name] = float(merged[name].detach())
                callback(i, info, z)

    for leaf in leaves + (ema_leaves or []):
        leaf.requires_grad_(False)
    final = {"train": train_p, "notrain": notrain}
    ema_full = {"train": ema, "notrain": notrain} if use_ema else None
    return TrainResult(
        params=final,
        ema_params=ema_full,
        losses=torch.tensor(losses),
        diverged=diverged,
        steps_done=steps_done,
        last_losses=ring,
    )


def mfvi_pretrain(
    dim: int,
    target_log_prob,
    *,
    lr: float = 0.01,
    iters: int = 150_000,
    batch_size: int = 5,
    generator=None,
    init_sigma: float = 1.0,
    callback=None,
    device=None,
):
    """Mean-field VI pretraining of the variational distribution, as a
    bounding machine with nbridges 0 trained on the KL bound (the mode is
    irrelevant without bridges). Returns (vd, elbo, TrainResult) with elbo
    minus the mean of the last 500 per-iteration losses. device=None is the
    card (utils/device.resolve_device)."""
    device = resolve_device(device)
    setup = bounds.CMCDSetup(mode="MCD_ULA", dim=dim, nbridges=0)
    params, ctx = bounds.initialize(
        setup, target_log_prob, trainable=("vd",), init_sigma=init_sigma, device=device
    )
    result = train(
        setup,
        params,
        ctx,
        lr=lr,
        iters=iters,
        batch_size=batch_size,
        generator=generator,
        trainable=("vd",),
        loss_fn=bounds.kl_bound,
        callback=callback,
        track_last_losses=min(500, iters),
    )
    vd = result.params["train"]["vd"]
    ring = result.last_losses
    elbo = -torch.nanmean(ring) if ring is not None else torch.tensor(math.nan)
    return vd, float(elbo), result
