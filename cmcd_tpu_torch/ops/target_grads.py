"""Target scores in the form the fused rollout computes them
(cmcd_tpu/ops/target_grads.py).

The CUDA kernel (csrc/overdamped.cu) inlines the many_gmm score; this module
holds its plain twin and the registry that tells the wrapper which targets
the kernel can integrate. Like the TPU kernel, the score ignores the -1e4
floor of the batched log_prob: inside the support the two agree, outside it
the floored log_prob has a zero gradient and this score does not.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from cmcd_tpu_torch.targets.gmm import many_gmm_means, many_gmm_scale


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


def make_many_gmm_score(device=None, log_var_scaling: float = 0.1) -> ManyGMMScore:
    scale = many_gmm_scale(log_var_scaling)
    return ManyGMMScore(means=many_gmm_means(device), inv_var=1.0 / (scale * scale))


def score_for_target(target, device=None) -> Optional[ManyGMMScore]:
    """The kernel-form score of `target`, or None where the kernel has none
    (see ROADMAP queue B, B11)."""
    if target.name != "many_gmm":
        return None
    p = target.params
    if (p.get("n_mixes"), float(p.get("loc_scaling", 0)), p.get("seed")) != (40, 40.0, 0):
        return None
    return make_many_gmm_score(device, p.get("log_var_scaling", 0.1))
