"""The evaluation entry through the fused rollouts
(cmcd_tpu/ops/fused.py::compute_elbos_fused and supports_fused).

The variational draw, the initial and final log-prob terms and the beta grid
stay in plain torch; the K-step loop runs in one launch of a CUDA kernel:
the overdamped rollout (ops/overdamped.py) for the CAIS, ULA_sn, ULA and DNF modes, the
underdamped rollout (ops/underdamped.py) for the seven underdamped modes,
the UHA rollout (ops/uha.py) for UHA; on the 1600-D LGCP the wide rollout
(ops/overdamped_wide.py), for MCD_CAIS_sn with the geffner net; on the
Bayesian logistic regressions the overdamped rollout's logreg instances, for
MCD_CAIS_sn with the geffner net. Forward only: evaluation, sampling, ln Z.
"""

from __future__ import annotations

import torch

from cmcd_tpu_torch import bounds
from cmcd_tpu_torch.distributions import diag_gaussian_log_prob, diag_gaussian_sample
from cmcd_tpu_torch.integrators import OVERDAMPED, UNDERDAMPED
from cmcd_tpu_torch.ops import overdamped, overdamped_wide, uha, underdamped
from cmcd_tpu_torch.ops.target_grads import (
    KERNEL_DIMS,
    LOGREG_TARGETS,
    WIDE_TARGETS,
    n_target_floats,
    score_for_target,
)
from cmcd_tpu_torch.schedules import betas_from_grid

# The PIS nets (ops/nets.py): the kernels take them in the overdamped modes
# with one net (cmcd_tpu/ops/fused.py::_arch_supported), not in the
# underdamped ones.
PIS_ARCHS = ("dds", "dds_grad")
# The modes of the wide forms (the LGCP): the wide rollout and the split
# sweep take the CAIS carry with one net. The JAX package's other modes on
# the LGCP wait in ROADMAP queue B.
WIDE_MODES = ("MCD_CAIS_sn",)
# The modes of the logistic regressions' instances (ops/target_grads.
# LOGREG_TARGETS): the CAIS rollout and the CAIS KL sweep with the geffner
# net. Their other modes and nets wait in ROADMAP queue B.
LOGREG_MODES = ("MCD_CAIS_sn",)


def net_width(setup: bounds.CMCDSetup) -> int:
    """The kernels' feature count of the score net in the mode of `setup`
    (0 without a net): geffner's in_dim, a PIS net's first width."""
    if setup.mode in UNDERDAMPED:
        din = underdamped.net_input_width(UNDERDAMPED[setup.mode], setup.dim)
        return din + setup.emb_dim if din else 0
    if setup.mode in OVERDAMPED and not overdamped.uses_net(OVERDAMPED[setup.mode]):
        return 0
    if setup.nn_arch in PIS_ARCHS:
        return setup.fully_connected_units[0]
    return setup.dim + setup.emb_dim


def net_supported(setup: bounds.CMCDSetup) -> bool:
    """The net the kernels inline for a mode that has one: the two-layer
    geffner net anywhere, a PIS net of two equal widths in an overdamped
    mode with one net (MCD_CAIS_sn, MCD_CAIS_var_sn, MCD_ULA_sn; the JAX
    package fuses no DNF with a PIS net either)."""
    if setup.nn_arch == "geffner":
        return setup.nlayers == 2
    units = tuple(setup.fully_connected_units)
    return (setup.nn_arch in PIS_ARCHS and setup.mode in OVERDAMPED
            and not OVERDAMPED[setup.mode].use_sn2_bwd
            and len(units) == 2 and units[0] == units[1])


def kernel_nets(setup: bounds.CMCDSetup) -> dict:
    """The keyword a kernel_fits takes for the nets of the setup's mode:
    {"nets": 2} for MCD_DNF (sn and sn2 in one block), else nothing."""
    return {"nets": 2} if setup.mode == "MCD_DNF" else {}


def wide_supported(setup: bounds.CMCDSetup, score) -> bool:
    """True if the wide forms take (mode, net) on a target of WIDE_TARGETS:
    MCD_CAIS_sn with the two-layer geffner net at the score's dim, at a
    width the wide kernels take (ops/overdamped_wide.kernel_fits). Every
    other mode and net on the LGCP is refused before any launch."""
    return (setup.mode in WIDE_MODES and setup.nn_arch == "geffner" and setup.nlayers == 2
            and setup.dim == score.dim and setup.nbridges >= 1
            and overdamped_wide.kernel_fits(net_width(setup), n_target_floats(score),
                                            setup.dim))


def logreg_supported(setup: bounds.CMCDSetup) -> bool:
    """True if the logistic regressions' instances take (mode, net):
    MCD_CAIS_sn with the geffner net. Every other mode and net on them is
    refused before any launch."""
    return setup.mode in LOGREG_MODES and setup.nn_arch == "geffner"


def supports_fused(setup: bounds.CMCDSetup, target) -> bool:
    """True if a kernel implements (mode, target score, net) at this size:
    an overdamped mode (all five; MCD_DNF reads only the target's D, with
    both of its nets geffner) on a target whose template is instantiated
    at the setup's dim (many_gmm, the 3-mode gmm: 2; the funnel: 10;
    ops/target_grads.KERNEL_DIMS), or an underdamped mode on a target of
    ops/underdamped.UD_TARGETS (the three), with (where the mode has a net)
    the net of net_supported at a width that fits one block's threads and
    shared memory (the rollout's kernel_fits); or UHA on a target of
    ops/uha.UHA_TARGETS with lfsteps the kernel takes
    (ops/uha.kernel_covers); or on the LGCP what the wide forms take
    (wide_supported); or on a logistic regression (dim 15, 35, 61) what
    its instances take (logreg_supported) at a width that fits."""
    score = score_for_target(target)
    if score is None:
        return False
    if score.kernel_name in WIDE_TARGETS:
        return wide_supported(setup, score)
    if score.kernel_name in LOGREG_TARGETS and not logreg_supported(setup):
        return False
    if setup.mode == "UHA":
        return uha.kernel_covers(score, setup.dim, setup.nbridges, setup.lfsteps)
    if setup.mode in OVERDAMPED:
        fits = overdamped.kernel_fits
    elif setup.mode in UNDERDAMPED and score.kernel_name in underdamped.UD_TARGETS:
        fits = underdamped.kernel_fits
    else:
        return False
    if setup.dim != KERNEL_DIMS.get(score.kernel_name) or setup.nbridges < 1:
        return False
    if getattr(score, "dim", setup.dim) != setup.dim:
        return False
    width = net_width(setup)
    if width == 0:  # no net: the target alone decides
        return n_target_floats(score) <= overdamped.MAX_TARGET_FLOATS
    return net_supported(setup) and fits(width, n_target_floats(score), setup.dim,
                                         **kernel_nets(setup))


@torch.no_grad()
def compute_elbos_fused(params, n_chains: int, setup: bounds.CMCDSetup, target,
                        *, generator=None, base_normals=None, noise=None, rollout=None):
    """Per-chain negative ELBOs via the fused rollout: (neg_elbos (N,), z (N, dim)).

    Same contract as bounds.compute_elbos. The kernel's Philox seed is drawn
    from `generator` on the device, so consecutive calls need no host sync.
    base_normals (N, dim) / noise ((K, N, dim) overdamped, (K + 1, N, dim)
    underdamped or UHA): optional draws standing in for the generator's. rollout:
    None for the kernel's wrapper of the mode's family, or a stand-in with
    its signature (the plain version, when the two are compared on the card).
    """
    if not supports_fused(setup, target):
        raise NotImplementedError(
            f"no fused kernel for mode {setup.mode} on {target.name} "
            f"(nn {setup.nn_arch}, emb_dim {setup.emb_dim}, units "
            f"{list(setup.fully_connected_units)}); see ROADMAP queue B"
        )
    p = bounds.merged_params(params)
    vd = p["vd"]
    dev = vd["mean"].device
    z0 = diag_gaussian_sample(vd, n_chains, generator=generator,
                              base_normals=base_normals)
    w0 = -diag_gaussian_log_prob(vd, z0)
    betas = betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])
    seed = torch.randint(2**31 - 1, (1,), generator=generator, device=dev)
    score = score_for_target(target, dev)
    common = dict(dim=setup.dim, nbridges=setup.nbridges, seed=seed, noise=noise)
    if setup.mode == "UHA":
        z, w_delta = (rollout or uha.evolve_uha_fused)(
            z0.contiguous(), betas.contiguous(), p["eps"], p["eta"], p["md"].contiguous(),
            vd["mean"].contiguous(), vd["logdiag"].contiguous(), score,
            lfsteps=setup.lfsteps, **common,
        )
        w = w0 + w_delta
    elif setup.mode in UNDERDAMPED:
        z, w = (rollout or underdamped.evolve_underdamped_fused)(
            z0.contiguous(), w0.contiguous(), betas.contiguous(), p["eps"], p["gamma"],
            p["eta"], vd["mean"].contiguous(), vd["logdiag"].contiguous(), score,
            UNDERDAMPED[setup.mode], sn=p.get("sn"), **common,
        )
    else:
        wide = score.kernel_name in WIDE_TARGETS
        z, w = (rollout or (overdamped_wide.evolve_overdamped_wide if wide
                            else overdamped.evolve_overdamped_fused))(
            z0.contiguous(), w0.contiguous(), betas.contiguous(), p["eps"],
            vd["mean"].contiguous(), vd["logdiag"].contiguous(), score,
            OVERDAMPED[setup.mode], eps_schedule=setup.eps_schedule,
            grad_clipping=setup.grad_clipping, sn=p.get("sn"),
            **({"sn2": p["sn2"]} if "sn2" in p else {}), **common,
        )
    w = w + target.log_prob(z)
    return -w, z
