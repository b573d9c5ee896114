"""Batched elementary distributions (counterpart of cmcd_tpu/distributions.py).

Batch-first: `z` is (N, dim) and log-probs return (N,). The momentum
distribution of UHA is a zero-mean diagonal Gaussian with log-scale `md`.
"""

from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)


def diag_gaussian_init(dim: int, init_sigma: float = 1.0, device=None):
    """Params of a mean-field Gaussian: {mean, logdiag}."""
    return {
        "mean": torch.zeros(dim, device=device),
        "logdiag": torch.full((dim,), math.log(init_sigma), device=device),
    }


def diag_gaussian_log_prob(params, z):
    """log q(z) for a batch. z: (N, dim) -> (N,)."""
    mean, logdiag = params["mean"], params["logdiag"]
    y = (z - mean) * torch.exp(-logdiag)
    return -0.5 * torch.sum(y * y + LOG_2PI, dim=-1) - torch.sum(logdiag)


def diag_gaussian_grad_log_prob(params, z):
    """Analytic d/dz log q(z) = -(z - mean) / sigma^2. (N, dim) -> (N, dim)."""
    mean, logdiag = params["mean"], params["logdiag"]
    return -(z - mean) * torch.exp(-2.0 * logdiag)


def diag_gaussian_sample(params, n: int, *, generator=None, base_normals=None):
    """Reparameterised batch sample mean + sigma * eps: (n, dim).

    base_normals: optional (n, dim) standard normals standing in for the
    draw from `generator` (tests hand both packages the same normals).
    """
    mean, logdiag = params["mean"], params["logdiag"]
    if base_normals is None:
        base_normals = torch.randn(
            (n, mean.shape[0]), generator=generator, device=mean.device
        )
    return mean + torch.exp(logdiag) * base_normals


def kernel_log_prob(x, mean, scale):
    """log N(x; mean, scale^2 I) summed over dim. x, mean: (N, dim) -> (N,)."""
    scale = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    y = (x - mean) / scale
    log_scale = torch.log(scale).expand(x.shape)
    return -0.5 * torch.sum(y * y + LOG_2PI, dim=-1) - torch.sum(log_scale, dim=-1)


def momentum_init(dim: int, device=None):
    """The momentum log-scale md of UHA: zeros of dim (unit scale)."""
    return torch.zeros(dim, device=device)


def momentum_sample_fresh(logscale, n: int, *, generator=None):
    """A fresh momentum draw exp(md) * xi for n chains: (n, dim)."""
    xi = torch.randn((n, logscale.shape[0]), generator=generator, device=logscale.device)
    return torch.exp(logscale) * xi


def momentum_log_prob(rho, logscale):
    """log N(rho; 0, exp(logscale)^2) summed over dim. rho: (N, dim) -> (N,)."""
    y = rho * torch.exp(-logscale)
    return -0.5 * torch.sum(y * y + LOG_2PI, dim=-1) - torch.sum(logscale)


def std_normal_log_prob(x):
    """log N(x; 0, I) summed over the last axis: (N, dim) -> (N,)."""
    return -0.5 * torch.sum(x * x + LOG_2PI, dim=-1)
