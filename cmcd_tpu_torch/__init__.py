"""cmcd_tpu_torch: the PyTorch/CUDA port of cmcd_tpu.

The JAX package `cmcd_tpu` is the reference; this package mirrors its module
names with PyTorch idiom inside (an `nn.Module` for the score network, plain
functions on tensors elsewhere, an explicit `device`, and an explicit
`torch.Generator` wherever JAX takes a key). Public functions keep the JAX
layout: `z` is (N, dim), `w` is (N,), injected noise is (K, N, dim) for the
overdamped modes and (K + 1, N, dim) for the underdamped ones (row 0 the
initial momentum), f32.

What it covers so far: all 13 boundmodes (the five overdamped ones, MCD_DNF
with its second net among them, the seven underdamped ones and UHA) on the
many_gmm, 3-mode gmm, funnel and LGCP targets, the geffner score net on [z]
or [z, rho] and the PIS nets, the ELBO/VarGrad/KL losses with their
gradients, the trainer (elementwise clip then Adam, projection, EMA, NaN
guard, MFVI pretraining), the 30x500 evaluation and the `--config.*` CLI. On
the card each training step runs two hand-written CUDA kernels (`csrc/`), a
rollout that stores what its backward needs and that backward, joined in
`ops/fused_train.py`; evaluation runs the mode's rollout alone. The other
targets, checkpoints and W2 are still to be ported (ROADMAP queues A and B).

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
