"""The reference against the port's eager path at a small size (the same
weights and the same injected draws), its targets against the port's, its
Philox draws against the generator's published answers, and the work counts
against the flagship's bounds."""

import math

import pytest
import torch

from portbench import harness
from portbench.program import LEAVES, Program
from portbench.reference import cmcd
from portbench.reference.philox import philox_normals, philox_words
from portbench.tests.conftest import any_cell, small


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    cases = [((0, 0, 0, 0, 0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 6, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344, 0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for args, want in cases:
        assert tuple(int(w) for w in philox_words(*args)) == want


def test_philox_normals_are_normal():
    xi = philox_normals([12345], 4000, range(3), 5, torch.device("cpu"))
    assert xi.shape == (1, 3, 4000, 5) and xi.dtype == torch.float32
    assert abs(float(xi.mean())) < 0.02 and abs(float(xi.std()) - 1.0) < 0.02


@pytest.mark.parametrize("config", ["many_gmm_var", "lgcp_k8"])
def test_target_matches_port(config, cpu):
    from cmcd_tpu_torch.config import get_config
    from cmcd_tpu_torch.targets import load_target

    mine = harness.load_module("reference", config).make_target(cpu)
    cfg = get_config()
    port = load_target("many_gmm" if config == "many_gmm_var" else "lgcp", cfg, device=cpu)
    g = torch.Generator().manual_seed(3)
    centre = 0.0 if config == "many_gmm_var" else mine.mu
    x = (centre + 10.0 * torch.randn(64, mine.dim, generator=g) / math.sqrt(mine.dim)
         ).requires_grad_(True)
    lp = port.log_prob(x)
    (score,) = torch.autograd.grad(lp.sum(), x)
    assert torch.allclose(mine.log_prob(x), lp, rtol=1e-5, atol=1e-3)
    assert torch.allclose(mine.score(x.detach()), score, rtol=1e-4, atol=1e-3)


def _port_leaves(prog):
    from cmcd_tpu_torch.train.trainer import tree_leaf_names, tree_leaves

    names, leaves = tree_leaf_names(prog.params["train"]), tree_leaves(prog.params["train"])
    return {LEAVES[n]: leaf for n, leaf in zip(names, leaves) if n in LEAVES}


@pytest.mark.parametrize("cell", ["many_gmm_var.train", "lgcp_k8.train"])
def test_loss_and_gradients_match_port_eager(cell, cpu):
    """The reference's negative ELBOs, loss and gradients against the port's
    eager bounds (bounds.var_bound / kl_bound through the eager
    integrator) under the same injected draws."""
    from cmcd_tpu_torch import bounds

    c = harness.override(any_cell(cell), small(cell))
    config = c["config"]
    weights = harness.make_weights(config, 11, cpu)
    prog = Program(config, {k: v.clone() for k, v in weights.items()}, cpu)
    spec = harness.reference_spec(config, config["flags"]["N"])
    g = torch.Generator().manual_seed(5)
    base = torch.randn(spec.n_chains, spec.dim, generator=g)
    noise = torch.randn(spec.nbridges, spec.n_chains, spec.dim, generator=g)

    port = _port_leaves(prog)
    for leaf in port.values():
        leaf.requires_grad_(True)
    loss_fn = bounds.loss_fn_for_mode(prog.setup.mode)
    value, (ne_port, _) = loss_fn(prog.params, spec.n_chains, prog.ctx, prog.setup,
                                  base_normals=base, noise=noise)
    names = config["trainable"]
    g_port = torch.autograd.grad(value, [port[k] for k in names], allow_unused=True)

    target = harness.load_module("reference", config["name"]).make_target(cpu)
    p = {k: v.clone().requires_grad_(k in names) for k, v in weights.items()}
    ne, _ = cmcd.neg_elbos(p, target, spec, base, lambda i: noise[i])
    mine = cmcd.loss(p, target, spec, base, lambda i: noise[i])
    g_mine = torch.autograd.grad(mine, [p[k] for k in names], allow_unused=True)

    assert torch.allclose(ne, ne_port, rtol=1e-5, atol=1e-4)
    assert math.isclose(float(mine), float(value), rel_tol=1e-5)
    for k, a, b in zip(names, g_mine, g_port):
        a = torch.zeros_like(p[k]) if a is None else a
        b = torch.zeros_like(p[k]) if b is None else b
        scale = float(b.abs().max()) + 1e-6
        assert float((a - b).abs().max()) <= 1e-4 * scale + 1e-6, k


def test_work_counts_pin_the_flagship_bounds():
    """PERF.md's flagship bounds at N=2000, K=256, emb 130: the rollout
    0.279 ms, the replay backward 0.822 ms (55.1 GFLOP), at 67 TFLOP/s."""
    c = any_cell("many_gmm_var.train")
    work = c["work"].per_unit(c["config"], c["traffic"])
    peaks = harness.load_json("", "peaks")["NVIDIA H100 80GB HBM3"]
    bound = {k: 1e3 * max(w["flops"] / peaks["fp32_flops_per_s"],
                          w["bytes"] / peaks["bytes_per_s"]) for k, w in work.items()}
    assert round(bound["rollout"], 3) == 0.279
    assert round(bound["backward"], 3) == 0.822
    assert round(work["backward"]["flops"] / 1e9, 1) == 55.1
