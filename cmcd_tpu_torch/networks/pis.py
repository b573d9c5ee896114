"""PIS / DDS drift networks with sinusoidal time embeddings
(cmcd_tpu/networks/pis.py).

PISNet ("dds"): the time t = i (the bridge index, as a float) is embedded as
[sin(coeff * t + phase), cos(coeff * t + phase)] with coeff the
`channels` = units[0] frequencies linspace(0.1, 100) (a buffer, not
trained) and phase trained; a time coder Linear -> gelu -> Linear maps it
to h_t (channels); the state net [Linear + gelu]* on [x, h_t] ends in a
zero-initialised Linear to x_dim, whose output is clipped at +-1e4. So the
net is an exact zero at init.

PISGradNet ("dds_grad") adds a gate MLP on the same embedding, Linear ->
[gelu -> Linear]* ending in a zero-initialised layer to x_dim, whose output
g_t multiplies the target score of x[:, :x_dim], detached and clipped at
+-1e2: out = clip(state net) + g_t * clip(grad log pi(x[:, :x_dim])). The
score comes from autograd of the target's log-prob, as the JAX scan path's
jax.grad, so it is 0 where many_gmm's log-prob floor holds.

gelu is exact (erf-based), as the scan path's. The time is not clamped:
the CAIS backward net asks for t = K at the last step.

Weights follow haiku's Linear init: truncated normal on (-2, 2) standard
deviations with std 1 / sqrt(fan_in), zero bias, drawn from the caller's
torch.Generator (their bits differ from JAX's PRNGKey init; the tests share
weights through utils/convert.py). The coefficients of a fresh net are
linspace(0.1, 100, channels) formed in float64 and rounded once to
float32, which gives the same bits on every device; jnp.linspace forms them
in float32 and differs from these in 57 of 64 entries, by at most two ulp
(7.6e-6 at most; at t = 256 a shift of ~2e-3 in the sine's argument). The
converter (utils/convert.pis_from_jax) overwrites the buffer with JAX's
bits, so that both packages compute the same function in the tests.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

NN_CLIP = 1.0e4    # the state net's output clip
LGV_CLIP = 1.0e2   # dds_grad's clip of the score feature


def gelu(x):
    """Exact, erf-based gelu (jax.scipy.special.erf in the JAX package)."""
    return F.gelu(x, approximate="none")


def _linear(fan_in, fan_out, generator, device, zero=False):
    lin = nn.Linear(fan_in, fan_out, device=device)
    with torch.no_grad():
        if zero:
            lin.weight.zero_()
        else:
            std = 1.0 / math.sqrt(fan_in)
            nn.init.trunc_normal_(lin.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
        lin.bias.zero_()
    return lin


def time_coefficients(channels: int, device=None):
    """linspace(0.1, 100, channels) in float64, rounded once to float32."""
    return torch.linspace(0.1, 100.0, channels, dtype=torch.float64, device=device).float()


class PISNet(nn.Module):
    """The "dds" net: forward(x (N, x_dim + rho_dim), i) -> (N, x_dim)."""

    def __init__(self, x_dim, fully_connected_units=(64, 64), rho_dim=0, generator=None,
                 device=None):
        super().__init__()
        units = list(fully_connected_units)
        channels = units[0]
        self.x_dim, self.rho_dim, self.units, self.channels = x_dim, rho_dim, units, channels
        self.in_dim = x_dim + rho_dim
        self.register_buffer("coeff", time_coefficients(channels, device))
        self.timestep_phase = nn.Parameter(torch.zeros(channels, device=device))
        self.time_coder = nn.ModuleList([
            _linear(2 * channels, channels, generator, device),
            _linear(channels, channels, generator, device),
        ])
        self.state_net = self._state_net(units, generator, device)

    def time_coder_layers(self):
        """The time coder's two Linears (JAX: "time_coder" of dds,
        "time_coder_state" of dds_grad)."""
        return self.time_coder

    def _state_net(self, units, generator, device):
        layers, prev = [], self.in_dim + self.channels
        for u in units:
            layers.append(_linear(prev, u, generator, device))
            prev = u
        layers.append(_linear(prev, self.x_dim, generator, device, zero=True))
        return nn.ModuleList(layers)

    def embedding(self, t):
        """[sin, cos](coeff * t + phase) for a float32 time t (scalar, or a
        column (T, 1) for T times at once): (..., 2 * channels)."""
        arg = self.coeff * t + self.timestep_phase
        return torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)

    def time_code(self, emb):
        """The time coder's output h_t from the embedding."""
        tc0, tc1 = self.time_coder_layers()
        return tc1(gelu(tc0(emb)))

    def state_out(self, x, h_t):
        """The clipped state net on [x, h_t] (h_t broadcast over the chains)."""
        h = torch.cat([x, h_t.expand(*x.shape[:-1], h_t.shape[-1])], dim=-1)
        for layer in self.state_net[:-1]:
            h = gelu(layer(h))
        return torch.clamp(self.state_net[-1](h), -NN_CLIP, NN_CLIP)

    def forward(self, x, i):
        t = torch.tensor(float(i), dtype=torch.float32, device=x.device)
        return self.state_out(x, self.time_code(self.embedding(t)))


class PISGradNet(PISNet):
    """The "dds_grad" net: PISNet plus the gated, detached, clipped target
    score of x[:, :x_dim] (target_log_prob: batched (N, x_dim) -> (N,))."""

    def __init__(self, x_dim, fully_connected_units=(64, 64), rho_dim=0,
                 target_log_prob=None, generator=None, device=None):
        if target_log_prob is None:
            raise ValueError("dds_grad arch needs target_log_prob for its grad feature")
        nn.Module.__init__(self)
        units = list(fully_connected_units)
        channels = units[0]
        self.x_dim, self.rho_dim, self.units, self.channels = x_dim, rho_dim, units, channels
        self.in_dim = x_dim + rho_dim
        self.target_log_prob = target_log_prob
        self.register_buffer("coeff", time_coefficients(channels, device))
        self.timestep_phase = nn.Parameter(torch.zeros(channels, device=device))
        # The JAX package's draw order: time coder, gate, state net.
        self.time_coder_state = nn.ModuleList([
            _linear(2 * channels, channels, generator, device),
            _linear(channels, channels, generator, device),
        ])
        gate = [_linear(2 * channels, channels, generator, device)]
        gate += [_linear(channels, channels, generator, device) for _ in units]
        gate.append(_linear(channels, x_dim, generator, device, zero=True))
        self.time_coder_grad = nn.ModuleList(gate)
        self.state_net = self._state_net(units, generator, device)

    def time_coder_layers(self):
        return self.time_coder_state

    def gate(self, emb):
        """The gate g_t (x_dim) from the embedding."""
        g = self.time_coder_grad[0](emb)
        for layer in self.time_coder_grad[1:]:
            g = layer(gelu(g))
        return g

    def score_feature(self, x):
        """clip(grad log pi(x[:, :x_dim]), 1e2), detached."""
        with torch.enable_grad():
            z = x[..., :self.x_dim].detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self.target_log_prob(z).sum(), z)
        return torch.clamp(g, -LGV_CLIP, LGV_CLIP)

    def forward(self, x, i):
        t = torch.tensor(float(i), dtype=torch.float32, device=x.device)
        emb = self.embedding(t)
        return self.state_out(x, self.time_code(emb)) + self.gate(emb) * self.score_feature(x)


def build_pis_network(x_dim, fully_connected_units=(64, 64), rho_dim=0, generator=None,
                      device=None):
    """Returns (net, apply_fn) with apply_fn(net, x, i) = net(x, i)."""
    net = PISNet(x_dim, fully_connected_units, rho_dim, generator=generator, device=device)
    return net, lambda net_, x, i: net_(x, i)


def build_pis_grad_network(x_dim, fully_connected_units=(64, 64), rho_dim=0,
                           target_log_prob=None, generator=None, device=None):
    """Returns (net, apply_fn) for dds_grad."""
    net = PISGradNet(x_dim, fully_connected_units, rho_dim, target_log_prob,
                     generator=generator, device=device)
    return net, lambda net_, x, i: net_(x, i)
