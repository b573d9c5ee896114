"""Target scores in the form the fused rollout computes them
(cmcd_tpu/ops/target_grads.py).

The tile kernels take the target as a template parameter
(csrc/cmcd_common.cuh: ManyGmmTarget, Gmm3Target, FunnelTarget,
StdNormalTarget<10>, LogregTarget<D, R>), whose dimension D sizes every
per-chain array: the many_gmm score in every kernel, the 3-mode gmm's in all
but the underdamped ones, the funnel's and the standard normal's (D = 10) in
the overdamped ones, the Bayesian logistic regressions' (D = 15, 35, 61;
LOGREG_TARGETS) in the CAIS forms of the rollout and the KL sweep only,
built from sources of their own (csrc/overdamped_logreg.cu,
csrc/kl_logreg.cu), which read the dataset through a pointer of its own
(kernel_data). The wide forms (csrc/cmcd_wide.cuh: the rollout of
csrc/overdamped_wide.cu and the split sweep of csrc/kl_split.cu) take the
1600-D LGCP, unwhitened and whitened (WIDE_TARGETS), whose dense float32
matrix they read through a pointer of its own. This module holds their
plain twins, with the Hessian products the reverse sweeps need, the
registry that tells a wrapper which target its kernel integrates and at
which D (`kernel_name`, TARGETS, KERNEL_DIMS) and the flat vector of
constants every kernel reads its target from (target_floats). Like the TPU
kernel, the many_gmm score ignores the -1e4 floor of the batched log_prob:
inside the support the two agree, outside it the floored log_prob has a
zero gradient and this score does not.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from cmcd_tpu_torch.targets.gmm import gmm_constants, many_gmm_means, many_gmm_scale

# The kernels' target codes (csrc/cmcd_common.cuh for the tile kernels'
# template parameters, csrc/cmcd_wide.cuh for the LGCP's two forms), the
# state dimension each serves (T::D; the wide kernels take D at run time and
# the LGCP score is built for 1600), and how many constants a target may hand
# the tile kernels (64 many_gmm components).
TARGETS = {"many_gmm": 0, "gmm": 1, "funnel": 2, "std_normal": 3, "lgcp": 4,
           "lgcp_whitened": 5, "log_australian": 6, "log_ionosphere": 7, "log_sonar": 8}
KERNEL_DIMS = {"many_gmm": 2, "gmm": 2, "funnel": 10, "std_normal": 10, "lgcp": 1600,
               "lgcp_whitened": 1600, "log_australian": 15, "log_ionosphere": 35,
               "log_sonar": 61}
# The targets only the wide forms take (their net does not fit a tile).
WIDE_TARGETS = ("lgcp", "lgcp_whitened")
# The Bayesian logistic regressions: the CAIS rollout and the CAIS KL sweep
# with the geffner net are instantiated for them, in sources of their own
# (ops/overdamped.source_for); every other kernel form refuses them.
LOGREG_TARGETS = ("log_australian", "log_ionosphere", "log_sonar")
MAX_TARGET_FLOATS = 128


@dataclasses.dataclass(frozen=True)
class ManyGMMScore:
    """grad log p(x) = inv_var * (sum_k r_k(x) m_k - x) for the isotropic,
    equally weighted many_gmm; r is the max-subtracted softmax over the
    components of -0.5 * inv_var * |x - m_k|^2 (the per-component constants
    are equal and cancel)."""

    means: torch.Tensor  # (n_mixes, 2) f32
    inv_var: float       # 1 / softplus(0.1)^2

    kernel_name = "many_gmm"

    def __call__(self, x):
        """x: (N, 2) -> (N, 2)."""
        means = self.means.to(x.device, x.dtype)
        d2 = torch.sum((x[:, None, :] - means[None]) ** 2, dim=-1)  # (N, K)
        r = torch.softmax(-0.5 * self.inv_var * d2, dim=-1)
        return self.inv_var * (r @ means - x)

    def hvp(self, x, v):
        """The score's Jacobian-transpose product at x applied to v, both
        (N, 2) -> (N, 2), written out (the Hessian of log p is symmetric):
          H v = -a v + a^2 sum_k r_k c_k (c_k . v),
          d_k = m_k - x,  c_k = d_k - sum_i r_i d_i,  a = inv_var.
        The centred c_k states sum_k r_k d_k d_k^T - (sum r d)(sum r d)^T
        without its cancellation: between modes |d_k| reaches 40 sqrt(2) and
        the two sums agree to many digits. The reverse-sweep kernel
        (csrc/kl.cu) computes these lines per chain."""
        means = self.means.to(x.device, x.dtype)
        a = self.inv_var
        d = means[None] - x[:, None, :]                              # (N, K, 2)
        r = torch.softmax(-0.5 * a * torch.sum(d * d, dim=-1), dim=-1)
        c = d - torch.sum(r[..., None] * d, dim=1, keepdim=True)
        cv = torch.sum(c * v[:, None, :], dim=-1)                    # (N, K)
        return -a * v + a * a * torch.sum((r * cv)[..., None] * c, dim=1)


@dataclasses.dataclass(frozen=True)
class GMMScore:
    """grad log p for the symmetrised 3-mode mixture p = (f(x) + f(S x)) / 2,
    S the coordinate swap: a softmax over the 6 (component, branch) pairs b
    of their log-densities l_b (the equal weights cancel) weighting the
    pairs' Gaussian gradients g_b = -P_b (x - m_b), where the swapped branch
    has m_b = S m_k and P_b = S P_k S. The constants are float32 (the
    kernels'), cast to the input's dtype."""

    means: torch.Tensor     # (3, 2)
    precs: torch.Tensor     # (3, 2, 2): the components' inverse covariances
    log_norm: torch.Tensor  # (3,)

    kernel_name = "gmm"

    def _branches(self, x):
        """Per pair b (component-major, the unswapped three first): the
        responsibilities r (N, 6), the gradients g (N, 6, 2) and the
        precisions P (6, 2, 2), all in x's coordinates and dtype."""
        means, precs, log_norm = (t.to(x.device, x.dtype) for t in
                                  (self.means, self.precs, self.log_norm))
        means = torch.cat([means, means.flip(-1)])                   # (6, 2): S m_k
        precs = torch.cat([precs, precs.flip(-1, -2)])               # (6, 2, 2): S P_k S
        d = x[:, None, :] - means[None]                              # (N, 6, 2)
        y = torch.einsum("bij,nbj->nbi", precs, d)
        logp = -0.5 * torch.sum(d * y, dim=-1) + torch.cat([log_norm, log_norm])
        return torch.softmax(logp, dim=-1), -y, precs

    def __call__(self, x):
        """x: (N, 2) -> (N, 2)."""
        r, g, _ = self._branches(x)
        return torch.sum(r[..., None] * g, dim=1)

    def hvp(self, x, v):
        """The score's Jacobian applied to v (the Hessian of log p is
        symmetric), both (N, 2) -> (N, 2), written out:
          H v = sum_b r_b (c_b (c_b . v) - P_b v),  c_b = g_b - sum_i r_i g_i,
        the centred form of sum_b r_b (g_b g_b^T - P_b) v - g (g . v)."""
        r, g, precs = self._branches(x)
        c = g - torch.sum(r[..., None] * g, dim=1, keepdim=True)     # (N, 6, 2)
        cv = torch.sum(c * v[:, None, :], dim=-1)                    # (N, 6)
        pv = torch.einsum("bij,nj->nbi", precs, v)                   # (N, 6, 2)
        return torch.sum(r[..., None] * (cv[..., None] * c - pv), dim=1)


@dataclasses.dataclass(frozen=True)
class FunnelScore:
    """grad log p for Neal's funnel, v = x[0], x[1:] | v ~ N(0, e^v I)
    (cmcd_tpu/ops/target_grads.py::make_funnel_grad_t):
      d/dv = -v / sig^2 + e^{-v} sum_j x_j^2 / 2 - (dim - 1) / 2
      d/dx_j = -x_j e^{-v},
    e^{-v} unclipped, in the input's dtype."""

    dim: int
    sig: float

    kernel_name = "funnel"

    def __call__(self, x):
        """x: (N, dim) -> (N, dim)."""
        v, xs = x[:, :1], x[:, 1:]
        ev = torch.exp(-v)
        dv = (-v / (self.sig * self.sig) + 0.5 * ev * torch.sum(xs * xs, -1, keepdim=True)
              - 0.5 * (self.dim - 1))
        return torch.cat([dv, -xs * ev], dim=-1)

    def hvp(self, x, u):
        """The score's Jacobian applied to u (the Hessian of log p is
        symmetric), both (N, dim) -> (N, dim), written out (the Pallas sweep
        traces it with jax.vjp and never states it):
          (H u)_0 = (-1/sig^2 - e^{-v} sum_j x_j^2 / 2) u_0 + e^{-v} sum_j x_j u_j
          (H u)_j = e^{-v} (x_j u_0 - u_j)."""
        v, xs = x[:, :1], x[:, 1:]
        u0, us = u[:, :1], u[:, 1:]
        ev = torch.exp(-v)
        h0 = ((-1.0 / (self.sig * self.sig) - 0.5 * ev * torch.sum(xs * xs, -1, keepdim=True))
              * u0 + ev * torch.sum(xs * us, -1, keepdim=True))
        return torch.cat([h0, ev * (xs * u0 - us)], dim=-1)


@dataclasses.dataclass(frozen=True)
class StdNormalScore:
    """The standard normal at any dim: score -x, H u = -u
    (cmcd_tpu/ops/target_grads.py::make_std_normal_grad_t); the closed-form
    check of the kernels' D = 10 instances."""

    dim: int

    kernel_name = "std_normal"

    def __call__(self, x):
        return -x

    def hvp(self, x, u):
        return -u


@dataclasses.dataclass(frozen=True)
class LgcpScore:
    """grad log p for the LGCP (cmcd_tpu/ops/target_grads.py::make_lgcp_grad_t),
    mat the target's own float32 constants (targets/lgcp.py):
      unwhitened (mat = Sigma^{-1}):  -Sigma^{-1}(z - mu) + counts - a e^z
      whitened (mat = L):             -w + L^T (counts - a e^{L w + mu})
    in the input's dtype, e^z unclipped as in JAX."""

    whitened: bool
    mat: torch.Tensor     # (dim, dim) f32: Sigma^{-1}, or L
    counts: torch.Tensor  # (dim,) f32
    mu: float
    a: float

    @property
    def kernel_name(self) -> str:
        return "lgcp_whitened" if self.whitened else "lgcp"

    @property
    def dim(self) -> int:
        return self.mat.shape[0]

    def _consts(self, x):
        return self.mat.to(x.device, x.dtype), self.counts.to(x.device, x.dtype)

    def __call__(self, x):
        """x: (N, dim) -> (N, dim)."""
        m, counts = self._consts(x)
        if not self.whitened:
            return -((x - self.mu) @ m.T) + counts - self.a * torch.exp(x)
        return -x + (counts - self.a * torch.exp(x @ m.T + self.mu)) @ m

    def hvp(self, x, u):
        """The score's Jacobian applied to u, both (N, dim) -> (N, dim),
        written out (it is symmetric, which is why JAX's custom VJP reuses
        the same constants):
          unwhitened  -Sigma^{-1} u - a e^z * u
          whitened    -u - L^T (a e^{L w + mu} * L u)."""
        m, _ = self._consts(x)
        if not self.whitened:
            return -(u @ m.T) - self.a * torch.exp(x) * u
        return -u - (self.a * torch.exp(x @ m.T + self.mu) * (u @ m.T)) @ m


@dataclasses.dataclass(frozen=True)
class LogregScore:
    """grad log p for the Bayesian logistic regression
    (cmcd_tpu/ops/target_grads.py::make_logreg_grad_t) on the target's own
    float32 data (targets/logreg.py):
      g = -w + X^T (y - sigmoid(X w))
    in the input's dtype, sigmoid the stable torch.sigmoid. `data` is the
    kernels' copy: X^T (dim x n_data, row-major) then y."""

    kernel_name: str
    x: torch.Tensor     # (n_data, dim) f32
    y: torch.Tensor     # (n_data,) f32
    data: torch.Tensor  # ((dim + 1) * n_data,) f32

    @property
    def dim(self) -> int:
        return self.x.shape[1]

    @property
    def n_data(self) -> int:
        return self.x.shape[0]

    def _consts(self, w):
        return self.x.to(w.device, w.dtype), self.y.to(w.device, w.dtype)

    def __call__(self, w):
        """w: (N, dim) -> (N, dim)."""
        x, y = self._consts(w)
        return -w + (y - torch.sigmoid(w @ x.T)) @ x

    def hvp(self, w, u):
        """The score's Jacobian applied to u, both (N, dim) -> (N, dim),
        written out (the Pallas sweep traces it with jax.vjp and never
        states it; the Hessian is symmetric):
          H u = -u - X^T (s * X u),  s = sigmoid(l) (1 - sigmoid(l)),  l = X w,
        s formed as sigmoid(l) sigmoid(-l), which keeps its size where
        1 - sigmoid(l) would round to 0."""
        x, _ = self._consts(w)
        logits = w @ x.T
        s = torch.sigmoid(logits) * torch.sigmoid(-logits)
        return -u - (s * (u @ x.T)) @ x


def logreg_score(target, device=None) -> LogregScore:
    """The logistic regression score of `target`, from the float32 data the
    target built (moved only if `device` is another)."""
    c = target.constants
    move = lambda t: t if device is None else t.to(device)
    return LogregScore(kernel_name=target.name, x=move(c["x"]), y=move(c["y"]),
                       data=move(c["kernel_data"]))


def lgcp_score(target, device=None) -> LgcpScore:
    """The LGCP score of `target` at any num_dim, from the constants the
    target built (moved only if `device` is another)."""
    c, whitened = target.constants, bool(target.params["use_whitened"])
    move = lambda t: t if device is None else t.to(device)
    return LgcpScore(whitened=whitened, mat=move(c["chol" if whitened else "prec"]),
                     counts=move(c["counts"]), mu=c["mu"], a=c["a"])


@functools.lru_cache(maxsize=None)
def make_gmm_score(device=None) -> GMMScore:
    means, chols, _, log_norm = gmm_constants()
    precs = np.linalg.inv(chols @ np.swapaxes(chols, -1, -2))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return GMMScore(means=f32(means), precs=f32(precs), log_norm=f32(log_norm))


@functools.lru_cache(maxsize=None)
def make_many_gmm_score(device=None, log_var_scaling: float = 0.1) -> ManyGMMScore:
    scale = many_gmm_scale(log_var_scaling)
    return ManyGMMScore(means=many_gmm_means(device), inv_var=1.0 / (scale * scale))


def score_for_target(target, device=None) -> Optional[
        ManyGMMScore | GMMScore | FunnelScore | StdNormalScore | LgcpScore | LogregScore]:
    """The kernel-form score of `target`, or None where no score is written
    out (see ROADMAP queue B, B11). Which kernels take it, and at which
    dimension: its kernel_name (KERNEL_DIMS; a funnel of another funnel_d
    has a score but no kernel). The LGCP's only where JAX's _build_lgcp
    gives one: num_dim 1600 on the bundled data; a logistic regression's only
    for a target make_logreg built (its recorded dset, the JAX rule of
    grad_t_for_target). Both wrap the constants the target built, so a call
    builds nothing."""
    if target.name.startswith("log_"):
        if target.name not in LOGREG_TARGETS or not target.params.get("dset"):
            return None
        return logreg_score(target, device)
    if target.name == "lgcp":
        p = target.params
        if p.get("num_dim") != KERNEL_DIMS["lgcp"] or not p.get("default_data"):
            return None
        return lgcp_score(target, device)
    if target.name == "gmm":
        return make_gmm_score(device)
    if target.name == "funnel":
        return FunnelScore(dim=target.dim, sig=float(target.params.get("sig", 3.0)))
    if target.name == "std_normal":
        return StdNormalScore(dim=target.dim)
    if target.name != "many_gmm":
        return None
    p = target.params
    if (p.get("n_mixes"), float(p.get("loc_scaling", 0)), p.get("seed")) != (40, 40.0, 0):
        return None
    return make_many_gmm_score(device, p.get("log_var_scaling", 0.1))


def target_floats(grad_logp) -> torch.Tensor:
    """The constants a kernel's target reads, as one flat f32 tensor: the
    many_gmm means (n_mix x 2); the gmm means (3 x 2), the precisions'
    (p11, p12, p22) per component and the log-normalisers (3); the funnel's
    sig; the standard normal's precision, 1; the LGCP's mu and a (its
    matrix and counts go to the wide kernels through pointers of their own).
    Nothing dimension-sized: the kernel's D is the template's, or the wide
    forms' run-time dim. A logistic regression's: its prior precision, 1 (its
    data goes to the kernels through a pointer of its own, kernel_data)."""
    name = grad_logp.kernel_name
    if name in LOGREG_TARGETS:
        return torch.tensor([1.0], dtype=torch.float32)
    if name in WIDE_TARGETS:
        return torch.tensor([grad_logp.mu, grad_logp.a], dtype=torch.float32)
    if name == "many_gmm":
        return grad_logp.means.reshape(-1).to(torch.float32).contiguous()
    if name in ("funnel", "std_normal"):
        return torch.tensor([grad_logp.sig if name == "funnel" else 1.0], dtype=torch.float32)
    p = grad_logp.precs
    parts = [grad_logp.means, torch.stack([p[:, 0, 0], p[:, 0, 1], p[:, 1, 1]], -1),
             grad_logp.log_norm]
    return torch.cat([t.reshape(-1).to(torch.float32) for t in parts])


def kernel_target(grad_logp, device):
    """What a launch passes for its target: (template code, the constants on
    `device`, many_gmm's inverse variance or 0)."""
    return (TARGETS[grad_logp.kernel_name], target_floats(grad_logp).to(device),
            float(getattr(grad_logp, "inv_var", 0.0)))


def kernel_data(grad_logp):
    """What a tile launch passes for a target's dataset: (its flat f32
    tensor, n_data) for a logistic regression (LogregScore.data: X^T, then
    y), else (None, 0)."""
    if grad_logp.kernel_name in LOGREG_TARGETS:
        return grad_logp.data, grad_logp.n_data
    return None, 0


def n_target_floats(grad_logp) -> int:
    """The count of target_floats(grad_logp), what kernel_fits asks."""
    return target_floats(grad_logp).numel()
