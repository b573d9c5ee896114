"""cmcd_tpu_torch: the PyTorch/CUDA port of cmcd_tpu.

The JAX package `cmcd_tpu` is the reference; this package mirrors its module
names with PyTorch idiom inside (an `nn.Module` for the score network, plain
functions on tensors elsewhere, an explicit `device`, and an explicit
`torch.Generator` wherever JAX takes a key). Public functions keep the JAX
layout: `z` is (N, dim), `w` is (N,), injected noise is (K, N, dim), f32.

What it covers so far: the many_gmm target, the overdamped CAIS / CAIS_VAR
modes, the geffner score net, the ELBO/VarGrad values, and the 30x500
evaluation through the hand-written CUDA rollout kernel
(`csrc/overdamped.cu`). Training is not ported yet (ROADMAP queue A).

This package imports torch, numpy and the standard library only, never jax.
"""

__version__ = "0.1.0"

from cmcd_tpu_torch.bounds import (
    CMCDSetup,
    compute_elbos,
    default_trainable,
    initialize,
    kl_bound,
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
    "merged_params",
    "var_bound",
]
