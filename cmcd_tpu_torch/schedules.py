"""Annealing (beta) grid and step-size schedules (cmcd_tpu/schedules.py)."""

from __future__ import annotations

import math

import torch


def make_beta_grid_params(nbridges: int, ngridb: int = 32, mgridref_y=None, device=None):
    """Initial knots and interpolation grids: (mgridref_y, gridref_x, target_x)."""
    if mgridref_y is not None:
        ngridb = mgridref_y.shape[0] - 1
    else:
        ngridb = min(ngridb, nbridges)
        mgridref_y = torch.ones(ngridb + 1, device=device)
    gridref_x = torch.linspace(0.0, 1.0, ngridb + 2, device=device)
    target_x = torch.linspace(0.0, 1.0, nbridges + 2, device=device)[1:-1]
    return mgridref_y, gridref_x, target_x


def interp(x, xp, fp):
    """1-D linear interpolation with `jnp.interp`'s semantics.

    xp must be increasing. Below xp[0] the result is fp[0], above xp[-1] it
    is fp[-1]; the arithmetic, the right-sided knot search and the guard on
    a zero-width interval follow jnp.interp term by term.
    """
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= torch.finfo(xp.dtype).eps ** 2  # np.spacing(eps)
    f = torch.where(
        dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df
    )
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def betas_from_grid(mgridref_y, gridref_x, target_x):
    """betas = interp(target_x, gridref_x, [0, cumsum(y)/sum(y)])."""
    gridref_y = torch.cumsum(mgridref_y, 0) / torch.sum(mgridref_y)
    gridref_y = torch.cat([gridref_y.new_zeros(1), gridref_y])
    return interp(target_x, gridref_x, gridref_y)


def eps_linear(init_eps, i, nbridges: int, final_eps: float = 0.0001):
    """Linear decay from init_eps to final_eps."""
    return (final_eps - init_eps) / (nbridges - 1) * i + init_eps


def eps_cosine_sq(init_eps, i, nbridges: int, s: float = 0.008):
    """Cosine-squared decay with s = 0.008."""
    phase = i / nbridges
    return init_eps * math.cos((phase + s) / (1.0 + s) * 0.5 * math.pi) ** 2


def eps_at_step(eps, i: int, nbridges: int, schedule: str | None):
    """schedule in {None, "", "linear", "cos_sq"}; i is a Python int."""
    if schedule == "cos_sq":
        return eps_cosine_sq(eps, i, nbridges)
    if schedule == "linear":
        return eps_linear(eps, i, nbridges)
    return eps


def eps_per_step(eps, nbridges: int, schedule: str | None):
    """The step sizes of all bridges at once: (nbridges,), differentiable in
    a tensor `eps`; entry i equals eps_at_step(eps, i, nbridges, schedule)."""
    eps = torch.as_tensor(eps, dtype=torch.float32)
    steps = [eps_at_step(eps, i, nbridges, schedule) for i in range(nbridges)]
    return torch.stack([torch.as_tensor(e, device=eps.device) for e in steps])
