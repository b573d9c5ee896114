"""Geffner-style score network with a learned per-bridge embedding table
(cmcd_tpu/networks/geffner.py).

Two residual softplus blocks h <- h + softplus(Linear(h)), a Linear head to
x_dim, an embedding table emb[nbridges, emb_dim] and an output scale
factor_sn that starts at 0, so the net starts as an exact zero correction.
The bridge index is clamped to [0, nbridges - 1]: the CAIS backward kernel
asks for i + 1 = nbridges at the last step, where torch indexing would
raise (and an unchecked CUDA load would read past the table). With
rho_dim > 0 (the underdamped modes whose net sees [z, rho']) the input is
x_dim + rho_dim wide and the head still returns x_dim values.

Weights are torch's own glorot-normal with a Generator; they do not match
JAX's bits, so tests share weights through utils/convert.py.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def softplus(x):
    """Stable softplus max(x, 0) + log1p(exp(-|x|)), as jax.nn.softplus."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


class GeffnerNet(nn.Module):
    def __init__(self, x_dim, emb_dim, nbridges, nlayers=2,
                 generator=None, device=None, rho_dim=0):
        super().__init__()
        in_dim = x_dim + rho_dim + emb_dim
        self.x_dim, self.emb_dim, self.nbridges = x_dim, emb_dim, nbridges
        self.rho_dim = rho_dim
        self.in_dim = in_dim
        self.layers = nn.ModuleList(
            nn.Linear(in_dim, in_dim, device=device) for _ in range(nlayers)
        )
        self.head = nn.Linear(in_dim, x_dim, device=device)
        self.emb = nn.Parameter(torch.empty(nbridges, emb_dim, device=device))
        self.factor_sn = nn.Parameter(torch.zeros((), device=device))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """stax.Dense defaults: glorot-normal weights, normal(1e-2) biases;
        embedding normal * 0.05; factor_sn 0."""
        for lin in [*self.layers, self.head]:
            fan_out, fan_in = lin.weight.shape
            std = math.sqrt(2.0 / (fan_in + fan_out))
            lin.weight.normal_(0.0, std, generator=generator)
            lin.bias.normal_(0.0, 1e-2, generator=generator)
        self.emb.normal_(0.0, 0.05, generator=generator)
        self.factor_sn.zero_()

    def forward(self, x, i: int):
        """x: (N, x_dim + rho_dim), i: bridge index -> (N, x_dim)."""
        i = min(max(int(i), 0), self.nbridges - 1)
        emb = self.emb[i].expand(x.shape[0], self.emb_dim)
        h = torch.cat([x, emb], dim=-1)
        for layer in self.layers:
            h = h + softplus(layer(h))
        return self.head(h) * self.factor_sn


def build_geffner_network(x_dim, emb_dim, nbridges, nlayers=2,
                          generator=None, device=None, rho_dim=0):
    """Returns (net, apply_fn) with apply_fn(net, x, i) = net(x, i)."""
    net = GeffnerNet(x_dim, emb_dim, nbridges, nlayers,
                     generator=generator, device=device, rho_dim=rho_dim)
    return net, lambda net_, x, i: net_(x, i)
