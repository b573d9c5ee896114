"""cmcd_tpu_torch: the PyTorch/CUDA port of cmcd_tpu.

The JAX package `cmcd_tpu` is the reference; this package mirrors its module
names with PyTorch idiom inside (an `nn.Module` for the score network, plain
functions on tensors elsewhere, an explicit `device`, and an explicit
`torch.Generator` wherever JAX takes a key). Public functions keep the JAX
layout: `z` is (N, dim), `w` is (N,), injected noise is (K, N, dim) for the
overdamped modes and (K + 1, N, dim) for the underdamped ones (row 0 the
initial momentum), f32.

What it covers so far: the many_gmm target, the overdamped CAIS / CAIS_VAR
modes and the seven underdamped (leapfrog) modes, the geffner score net on
[z] or [z, rho], the ELBO/VarGrad/KL losses with their gradients, the trainer
(elementwise clip then Adam, projection, EMA, NaN guard, MFVI pretraining),
the 30x500 evaluation and the `--config.*` CLI. On the card each training
step runs two hand-written CUDA kernels, a rollout that stores what its
backward needs and that backward: VarGrad (`csrc/overdamped.cu`,
`csrc/vargrad.cu`), KL for MCD_CAIS_sn (`csrc/overdamped.cu`, `csrc/kl.cu`)
and KL for the approximate-refresh underdamped modes, LDVI among them
(`csrc/underdamped.cu`, `csrc/kl_underdamped.cu`), joined in
`ops/fused_train.py`; evaluation runs the mode's rollout alone. The other
targets, modes and nets, checkpoints and W2 are still to be ported (ROADMAP
queues A and B).

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
