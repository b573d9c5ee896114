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
        means = self.means.to(x.device)
        d2 = torch.sum((x[:, None, :] - means[None]) ** 2, dim=-1)  # (N, K)
        r = torch.softmax(-0.5 * self.inv_var * d2, dim=-1)
        return self.inv_var * (r @ means - x)


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
