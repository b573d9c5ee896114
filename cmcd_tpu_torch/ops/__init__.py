"""Fused kernels and their entry points. Nothing is compiled at import:
a kernel is built by ops/build.py the first time its wrapper launches it."""

from cmcd_tpu_torch.ops.fused import compute_elbos_fused, supports_fused
from cmcd_tpu_torch.ops.fused_train import (
    KL_FUSED_MODES,
    UD_KL_FUSED_MODES,
    UHA_KL_FUSED_MODES,
    fused_training_path,
    kl_bound_fused,
    neg_elbos_fused,
    neg_elbos_fused_kl,
    supports_fused_train,
    var_bound_fused,
)
from cmcd_tpu_torch.ops.kl import evolve_kl_bwd, evolve_kl_bwd_plain
from cmcd_tpu_torch.ops.kl_split import evolve_kl_split, evolve_kl_split_plain
from cmcd_tpu_torch.ops.kl_uha import evolve_kl_bwd_uha, evolve_kl_bwd_uha_plain
from cmcd_tpu_torch.ops.kl_underdamped import (
    evolve_kl_bwd_underdamped,
    evolve_kl_bwd_underdamped_plain,
)
from cmcd_tpu_torch.ops.overdamped import (
    evolve_overdamped_fused,
    evolve_overdamped_fused_plain,
)
from cmcd_tpu_torch.ops.overdamped_wide import (
    evolve_overdamped_wide,
    evolve_overdamped_wide_plain,
)
from cmcd_tpu_torch.ops.target_grads import score_for_target
from cmcd_tpu_torch.ops.uha import evolve_uha_fused, evolve_uha_fused_plain
from cmcd_tpu_torch.ops.underdamped import (
    evolve_underdamped_fused,
    evolve_underdamped_fused_plain,
)
from cmcd_tpu_torch.ops.vargrad import (
    evolve_vargrad_bwd_replay,
    evolve_vargrad_bwd_replay_plain,
    evolve_vargrad_bwd_reroll,
    evolve_vargrad_bwd_reroll_plain,
)

__all__ = [
    "KL_FUSED_MODES",
    "UD_KL_FUSED_MODES",
    "UHA_KL_FUSED_MODES",
    "compute_elbos_fused",
    "evolve_kl_bwd",
    "evolve_kl_bwd_plain",
    "evolve_kl_split",
    "evolve_kl_split_plain",
    "evolve_kl_bwd_underdamped",
    "evolve_kl_bwd_uha",
    "evolve_kl_bwd_uha_plain",
    "evolve_kl_bwd_underdamped_plain",
    "evolve_overdamped_fused",
    "evolve_overdamped_fused_plain",
    "evolve_overdamped_wide",
    "evolve_overdamped_wide_plain",
    "evolve_underdamped_fused",
    "evolve_uha_fused",
    "evolve_uha_fused_plain",
    "evolve_underdamped_fused_plain",
    "evolve_vargrad_bwd_replay",
    "evolve_vargrad_bwd_replay_plain",
    "evolve_vargrad_bwd_reroll",
    "evolve_vargrad_bwd_reroll_plain",
    "fused_training_path",
    "kl_bound_fused",
    "neg_elbos_fused",
    "neg_elbos_fused_kl",
    "score_for_target",
    "supports_fused",
    "supports_fused_train",
    "var_bound_fused",
]
