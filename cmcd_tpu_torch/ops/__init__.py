"""Fused kernels and their entry points. Nothing is compiled at import:
a kernel is built by ops/build.py the first time its wrapper launches it."""

from cmcd_tpu_torch.ops.fused import compute_elbos_fused, supports_fused
from cmcd_tpu_torch.ops.fused_train import (
    neg_elbos_fused,
    supports_fused_train,
    var_bound_fused,
)
from cmcd_tpu_torch.ops.overdamped import (
    evolve_overdamped_fused,
    evolve_overdamped_fused_plain,
)
from cmcd_tpu_torch.ops.target_grads import score_for_target
from cmcd_tpu_torch.ops.vargrad import (
    evolve_vargrad_bwd_replay,
    evolve_vargrad_bwd_replay_plain,
)

__all__ = [
    "compute_elbos_fused",
    "evolve_overdamped_fused",
    "evolve_overdamped_fused_plain",
    "evolve_vargrad_bwd_replay",
    "evolve_vargrad_bwd_replay_plain",
    "neg_elbos_fused",
    "score_for_target",
    "supports_fused",
    "supports_fused_train",
    "var_bound_fused",
]
