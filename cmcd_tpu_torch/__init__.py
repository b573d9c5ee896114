"""cmcd_tpu_torch: the PyTorch/CUDA port of cmcd_tpu.

The JAX package `cmcd_tpu` is the reference; this package mirrors its module
names with PyTorch idiom inside (an `nn.Module` for the score network, plain
functions on tensors elsewhere, an explicit `device`, and an explicit
`torch.Generator` wherever JAX takes a key). Public functions keep the JAX
layout: `z` is (N, dim), `w` is (N,), injected noise is (K, N, dim), f32.

What it covers so far: the many_gmm target, the overdamped CAIS / CAIS_VAR
modes, the geffner score net, the ELBO/VarGrad losses with their gradients,
the trainer (elementwise clip then Adam, projection, EMA, NaN guard, MFVI
pretraining), the 30x500 evaluation and the `--config.*` CLI. On the card
VarGrad training runs through two hand-written CUDA kernels, one launch
each per step: the rollout that stores its trajectory
(`csrc/overdamped.cu`) and the replay backward (`csrc/vargrad.cu`), joined
by `ops/fused_train.var_bound_fused`; evaluation runs the rollout alone.
The KL modes' fused training, the other targets, modes and nets,
checkpoints and W2 are still to be ported (ROADMAP queues A and B).

Entry points and constructors run on the card unless the caller passes
`device="cpu"` (`utils/device.py`).

This package imports torch, numpy and the standard library only, never jax.
"""

__version__ = "0.1.0"

from cmcd_tpu_torch.bounds import (
    CMCDSetup,
    compute_elbos,
    default_trainable,
    initialize,
    kl_bound,
    loss_fn_for_mode,
    merged_params,
    var_bound,
)
from cmcd_tpu_torch.targets import Target, load_target

__all__ = [
    "CMCDSetup",
    "Target",
    "compute_elbos",
    "default_trainable",
    "initialize",
    "kl_bound",
    "load_target",
    "loss_fn_for_mode",
    "merged_params",
    "var_bound",
]
