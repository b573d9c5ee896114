"""Plain PyTorch reference of Controlled Monte Carlo Diffusions (overdamped
CMCD: the CAIS rollout, trained with the KL or the VarGrad loss; Vargas et
al., "Transport meets Variational Inference: Controlled Monte Carlo
Diffusions", ICLR 2024, arXiv:2307.01198).

It imports nothing of the program it judges. Written from the method's
equations, step by step, with torch.autograd for every gradient:

  forward   z' = z - eps * gradU(z, b) - eps * sn(z, i) + sqrt(2 eps) xi
  backward  mean z' - eps * gradU(z', b) + eps * sn(z', i + 1)
  weight    w += log N(z; backward mean, 2 eps) - log N(z'; forward mean, 2 eps)
  gradU(z, b) = -(b * grad log pi(z) + (1 - b) * grad log q(z))

with q the mean-field Gaussian start, sn the two-block residual softplus net
on [z, emb_i] (Geffner et al.) scaled by factor, and the annealing b from a
monotone spline of 32 knots. VarGrad cuts every state from the graph (its
gradient is that of the variance of the negative ELBOs over the batch with
the states held fixed) and clips both scores at 1e2 when clipping is on;
the KL loss keeps the whole graph (backprop through time) and clips the
target score at 1e3. The optimizer is each gradient element clipped to +-5,
then Adam, then the projection of the step size and the spline knots.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

LOG_2PI = math.log(2.0 * math.pi)
NET_KEYS = ("W1", "b1", "W2", "b2", "Wh", "bh", "emb", "factor")


@dataclass(frozen=True)
class Spec:
    """One overdamped CMCD run: sizes, loss and clipping."""

    dim: int
    n_chains: int
    nbridges: int
    emb_dim: int
    loss: str            # "var" (VarGrad) or "kl"
    grad_clipping: bool
    ngridb: int = 32

    @property
    def in_dim(self) -> int:
        return self.dim + self.emb_dim

    @property
    def n_knots(self) -> int:
        return min(self.ngridb, self.nbridges) + 1


def softplus(x):
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def net_apply(w: dict, z: torch.Tensor, i: int) -> torch.Tensor:
    """The score net at bridge row min(i, K - 1): z (N, dim) -> (N, dim)."""
    row = min(max(i, 0), w["emb"].shape[0] - 1)
    h = torch.cat([z, w["emb"][row].expand(z.shape[0], -1)], dim=-1)
    h = h + softplus(F.linear(h, w["W1"], w["b1"]))
    h = h + softplus(F.linear(h, w["W2"], w["b2"]))
    return F.linear(h, w["Wh"], w["bh"]) * w["factor"]


def gaussian_log_prob(z, mean, logdiag):
    y = (z - mean) * torch.exp(-logdiag)
    return -0.5 * torch.sum(y * y, -1) - 0.5 * z.shape[-1] * LOG_2PI - torch.sum(logdiag)


def normal_log_prob(x, mean, scale):
    y = (x - mean) / scale
    return -0.5 * torch.sum(y * y, -1) - x.shape[-1] * (0.5 * LOG_2PI + torch.log(scale))


def betas(knots: torch.Tensor, nbridges: int) -> torch.Tensor:
    """The annealing at bridges 1..K of K + 1 equal intervals: linear
    interpolation of the knots' normalised cumulative sum, prefixed by 0, on
    a grid of len(knots) + 1 equal intervals."""
    xp = torch.linspace(0.0, 1.0, knots.shape[0] + 1, device=knots.device)
    fp = torch.cat([knots.new_zeros(1), torch.cumsum(knots, 0) / torch.sum(knots)])
    x = torch.linspace(0.0, 1.0, nbridges + 2, device=knots.device)[1:-1]
    hi = torch.searchsorted(xp, x, right=True).clamp(1, xp.shape[0] - 1)
    lo = hi - 1
    return fp[lo] + (x - xp[lo]) / (xp[hi] - xp[lo]) * (fp[hi] - fp[lo])


def rollout(params: dict, z0: torch.Tensor, target, spec: Spec, noise):
    """K steps of CAIS from z0: (z_K, w). noise(i) -> (N, dim) standard
    normals of step i. VarGrad detaches each state."""
    var = spec.loss == "var"
    clip_t = (1e2 if var else 1e3) if spec.grad_clipping else None
    clip_q = 1e2 if (var and spec.grad_clipping) else None
    mean, logdiag = params["vd_mean"], params["vd_logdiag"]
    eps = params["eps"]
    scale = torch.sqrt(2.0 * eps)
    b = betas(params["knots"], spec.nbridges)

    def grad_u(z, beta):
        gt = target.score(z.detach() if var else z)
        gq = -(z - mean) * torch.exp(-2.0 * logdiag)
        if clip_t is not None:
            gt = torch.clamp(gt, -clip_t, clip_t)
        if clip_q is not None:
            gq = torch.clamp(gq, -clip_q, clip_q)
        return -(beta * gt + (1.0 - beta) * gq)

    z, w = z0, z0.new_zeros(z0.shape[0])
    for i in range(spec.nbridges):
        if var:
            z = z.detach()
        fwd = z - eps * grad_u(z, b[i]) - eps * net_apply(params, z, i)
        z_new = fwd + scale * noise(i)
        if var:
            z_new = z_new.detach()
        bwd = z_new - eps * grad_u(z_new, b[i]) + eps * net_apply(params, z_new, i + 1)
        w = w + normal_log_prob(z, bwd, scale) - normal_log_prob(z_new, fwd, scale)
        z = z_new
    return z, w


def neg_elbos(params: dict, target, spec: Spec, base_normals, noise):
    """Per-chain negative ELBOs and final states: z0 = mean + sigma * base."""
    z0 = params["vd_mean"] + torch.exp(params["vd_logdiag"]) * base_normals
    w0 = -gaussian_log_prob(z0, params["vd_mean"], params["vd_logdiag"])
    if spec.loss == "var":
        z0 = z0.detach()
    z, w = rollout(params, z0, target, spec, noise)
    log_pi = target.log_prob(z.detach() if spec.loss == "var" else z)
    return -(w0 + w + log_pi), z


def loss(params: dict, target, spec: Spec, base_normals, noise):
    ne, _ = neg_elbos(params, target, spec, base_normals, noise)
    if spec.loss == "var":
        return torch.clamp(torch.var(ne, correction=0), -1e7, 1e7)
    return torch.mean(ne)


def project(params: dict, trainable) -> None:
    """In place, on the trained leaves: eps in [1e-7, 0.5], knots >= 1e-3."""
    with torch.no_grad():
        if "eps" in trainable:
            params["eps"].clamp_(1e-7, 0.5)
        if "knots" in trainable:
            params["knots"].copy_(torch.relu(params["knots"] - 0.001) + 0.001)


class Adam:
    """Each gradient element clipped to +-clip, then Adam (Kingma and Ba)."""

    def __init__(self, leaves: dict, lr, b1=0.9, b2=0.999, eps=1e-8, clip=5.0):
        self.lr, self.b1, self.b2, self.eps, self.clip = lr, b1, b2, eps, clip
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, leaves: dict, grads: dict) -> dict:
        """Updates leaves in place; returns the clipped gradients."""
        self.t += 1
        clipped = {}
        for k, g in grads.items():
            g = torch.clamp(g, -self.clip, self.clip)
            clipped[k] = g
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            m_hat = self.m[k] / (1 - self.b1 ** self.t)
            v_hat = self.v[k] / (1 - self.b2 ** self.t)
            leaves[k].sub_(self.lr * m_hat / (torch.sqrt(v_hat) + self.eps))
        return clipped


def train_steps(params: dict, trainable, target, spec: Spec, lr: float, draws):
    """len(draws) optimizer steps from params (copied): draws yields
    (base_normals, noise) per step. Returns (losses, first clipped
    gradients by leaf, parameters after the last step)."""
    p = {k: v.detach().clone() for k, v in params.items()}
    leaves = {k: p[k] for k in trainable}
    opt = Adam(leaves, lr)
    losses, first = [], None
    for base, noise in draws:
        for v in leaves.values():
            v.requires_grad_(True)
        value = loss(p, target, spec, base, noise)
        names = list(leaves)
        grads = torch.autograd.grad(value, [leaves[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(names, grads)}
        for v in leaves.values():
            v.requires_grad_(False)
        clipped = opt.step(leaves, grads)
        project(p, leaves)
        losses.append(float(value.detach()))
        if first is None:
            first = clipped
    return losses, first, p


def summarize(ne: torch.Tensor):
    """Per seed group: ELBO = mean(-L), ln Z = logsumexp(-L) - log n. ne (S, n)."""
    n = ne.shape[-1]
    return -ne.mean(-1), torch.logsumexp(-ne, -1) - math.log(n)
