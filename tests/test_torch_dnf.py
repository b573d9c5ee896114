"""MCD_DNF (zero drift, a second net in the backward mean) in the port,
against the JAX package on the CPU under the same base normals and injected
noise.

Layers, each held to the JAX package: the eager rollout and the eager KL
bound's gradient (sn2's leaves included) against the scan integrator and
jax.grad of its loss; the rollout's plain version (B1's DNF form) against
evolve_overdamped_pallas in interpret mode; the sweep's plain version (B3's
DNF form) against evolve_kl_bwd_pallas in interpret mode on the same
trajectory, noise and cotangents; sn2 converted to the port and back, and
trained; five trainer steps against the JAX trainer; the CLI on the CPU; the
refusals that stand (DNF with a PIS net, DNF on the LGCP) before any launch.

Tolerances: the rollout z to 2e-5 and w to 2e-4 absolute (float32, 6-8
steps of two 16-wide nets in another summation order); losses rtol 1e-4;
gradients as tests/test_pallas_kl.py, |g_t - g_j| < 2e-4 |g_j| + 1e-4 over
the flattened tree and per leaf; trainer parameters 2e-4 per leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cmcd_tpu
from cmcd_tpu import bounds as jb
from cmcd_tpu import integrators as jintegrators
from cmcd_tpu.distributions import diag_gaussian_log_prob as j_log_prob
from cmcd_tpu.integrators import overdamped as jod
from cmcd_tpu.ops.fused import _dim_pad
from cmcd_tpu.ops.fused_train import kl_bound_pallas
from cmcd_tpu.ops.pallas_kl import evolve_kl_bwd_pallas
from cmcd_tpu.ops.pallas_overdamped import evolve_overdamped_pallas, pack_geffner_t
from cmcd_tpu.ops.target_grads import grad_t_for_target
from cmcd_tpu.schedules import betas_from_grid as j_betas_from_grid
from cmcd_tpu.train import trainer as jtrainer
from cmcd_tpu_torch import bounds as tb
from cmcd_tpu_torch import integrators
from cmcd_tpu_torch.integrators import overdamped as tod
from cmcd_tpu_torch.main import _use_fused, parse_flags, run_experiment
from cmcd_tpu_torch.networks import build_score_network
from cmcd_tpu_torch.ops import fused, fused_train, kl, overdamped
from cmcd_tpu_torch.ops.fused import compute_elbos_fused, supports_fused
from cmcd_tpu_torch.ops.fused_train import (
    KL_FUSED_MODES,
    OD_KL_FUSED_MODES,
    fused_training_path,
    kl_bound_fused,
    supports_fused_train,
)
from cmcd_tpu_torch.ops.kl import evolve_kl_bwd, evolve_kl_bwd_plain
from cmcd_tpu_torch.ops.overdamped import evolve_overdamped_fused, evolve_overdamped_fused_plain
from cmcd_tpu_torch.ops.target_grads import score_for_target
from cmcd_tpu_torch.schedules import betas_from_grid
from cmcd_tpu_torch.targets import load_target
from cmcd_tpu_torch.train import train
from cmcd_tpu_torch.train.trainer import tree_leaf_names, tree_leaves
from cmcd_tpu_torch.utils.convert import grads_to_numpy, params_from_jax, params_to_numpy
from test_torch_ula import OTHER_WRAPPERS
from test_torch_vargrad import assert_grads_close, torch_value_and_grad

torch.set_num_threads(1)

K, N, EMB = 6, 128, 16
TARGETS = ("gmm", "many_gmm", "funnel")
SIGMA = {"gmm": 3.0, "many_gmm": 8.0, "funnel": 1.0}
Z_ATOL, W_ATOL = 2e-5, 2e-4


def make_case(target_name="gmm", n=N, k=K, eps=0.1, train_eps=True, train_vi=True, seed=2):
    """One MCD_DNF problem in both packages: every leaf trainable (or as
    asked), both nets live (factor_sn 0.3 and 0.2, random heads),
    non-uniform beta knots, an off-centre variational mean."""
    jt = cmcd_tpu.load_target(target_name)
    dim = jt.dim
    kw = dict(mode="MCD_DNF", dim=dim, nbridges=k, emb_dim=EMB)
    jsetup = jb.CMCDSetup(**kw)
    trainable = jb.default_trainable("MCD_DNF", train_eps=train_eps, train_vi=train_vi)
    params, jctx = jb.initialize(jsetup, jt.log_prob, eps=eps, init_sigma=SIGMA[target_name],
                                 trainable=trainable)
    for key, factor, net_seed in (("sn", 0.3, 9), ("sn2", 0.2, 10)):
        net = params["train"][key]
        net["factor_sn"] = jnp.asarray(factor)
        net["head"]["w"] = 0.05 * jax.random.normal(jax.random.PRNGKey(net_seed),
                                                    net["head"]["w"].shape)
    params["train"]["mgridref_y"] = jax.random.uniform(
        jax.random.PRNGKey(4), params["train"]["mgridref_y"].shape, minval=0.5, maxval=1.5)
    params["train"]["vd"]["mean"] = jnp.asarray(
        [0.5 * (-1) ** d for d in range(dim)], jnp.float32)
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, dim)).astype(np.float32)
    noise = rng.standard_normal((k, n, dim)).astype(np.float32)
    target = load_target(target_name, device="cpu")
    tsetup = tb.CMCDSetup(**kw)
    _, tctx = tb.initialize(tsetup, target.log_prob, device="cpu")
    return {
        "jt": jt, "jsetup": jsetup, "jparams": params, "jctx": jctx, "key": jax.random.PRNGKey(0),
        "jnoise": jnp.asarray(noise), "jbase": jnp.asarray(base), "n": n, "k": k, "dim": dim,
        "rng": rng, "target": target, "setup": tsetup, "ctx": tctx, "trainable": trainable,
        "params": params_from_jax(jax.device_get(params), device="cpu"),
        "draws": {"base_normals": torch.from_numpy(base), "noise": torch.from_numpy(noise)},
    }


def scan_neg_elbos(case):
    """The JAX scan integrator's negative ELBOs under DNF, as a function of
    the trainable tree."""
    params, ctx, key = case["jparams"], case["jctx"], case["key"]

    def neg_elbos(train_p):
        p = jb.merged_params({"train": train_p, "notrain": params["notrain"]})
        z = p["vd"]["mean"] + jnp.exp(p["vd"]["logdiag"]) * case["jbase"]
        w = -j_log_prob(p["vd"], z)
        betas = j_betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])
        z, wd, _ = jod.evolve_overdamped(key, z, betas, p, ctx, jod.DNF, noise=case["jnoise"])
        return -(w + wd + ctx.target_log_prob(z))

    return neg_elbos


def port_args(case):
    """(z0, the port rollout's arguments after w0, its keywords)."""
    p = tb.merged_params(case["params"])
    betas = betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"]).detach()
    z0 = (p["vd"]["mean"] + torch.exp(p["vd"]["logdiag"]) * case["draws"]["base_normals"]).detach()
    args = (betas, p["eps"].detach(), p["vd"]["mean"].detach(), p["vd"]["logdiag"].detach(),
            score_for_target(case["target"]), tod.DNF)
    kw = dict(dim=case["dim"], nbridges=case["k"], sn=p["sn"], sn2=p["sn2"])
    return z0, args, kw


def jax_kernel_args(case):
    """The JAX kernels' arguments for the case: (z0, betas, eps, vd mean, vd
    logdiag, grad_t, spec) and the keywords with both nets packed."""
    p = jb.merged_params(case["jparams"])
    dim = case["dim"]
    dim_pad = _dim_pad(dim)
    betas = j_betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])
    z0 = p["vd"]["mean"] + jnp.exp(p["vd"]["logdiag"]) * case["jbase"]
    sn_w, sn_meta = pack_geffner_t(p["sn"], dim, dim_pad)
    sn2_w, _ = pack_geffner_t(p["sn2"], dim, dim_pad)
    args = (betas, p["eps"], p["vd"]["mean"], p["vd"]["logdiag"],
            grad_t_for_target(case["jt"], dim_pad), jod.DNF)
    kw = dict(dim=dim, nbridges=case["k"], sn_weights=sn_w, sn_meta=sn_meta,
              sn2_weights=sn2_w, block=128, interpret=True)
    return z0, args, kw


# --- the registry, the setup and the eager stepper --------------------------

def test_registry_and_setup_follow_the_jax_package():
    """All 13 boundmodes in JAX's order, DNF a state-net mode; its setup
    drops the eps schedule as JAX's does; initialize builds sn2 from seed + 1
    (a state-only geffner net, its own factor) and hands apply_sn2 on."""
    assert integrators.ALL_MODES == jintegrators.ALL_MODES and len(integrators.ALL_MODES) == 13
    assert integrators.OVERDAMPED["MCD_DNF"] == tod.DNF
    assert tod.DNF.zero_drift and tod.DNF.use_sn2_bwd and tod.DNF.bwd_sn_offset == 1
    assert integrators.mode_sn_rho_dim("MCD_DNF", 2) == 0
    setup = tb.CMCDSetup(mode="MCD_DNF", dim=2, nbridges=8, emb_dim=EMB, eps_schedule="cos_sq")
    assert setup.eps_schedule == "" == jb.CMCDSetup(**{**setup.__dict__}).eps_schedule
    target = load_target("gmm", device="cpu")
    params, ctx = tb.initialize(setup, target.log_prob, seed=3, device="cpu")
    sn, sn2 = params["train"]["sn"], params["train"]["sn2"]
    want, _ = build_score_network(2, EMB, 8, generator=torch.Generator().manual_seed(4))
    for (name, a), (_, b) in zip(sn2.named_parameters(), want.named_parameters()):
        assert torch.equal(a, b), name
    assert not torch.equal(sn.emb, sn2.emb) and sn2.rho_dim == 0
    assert ctx.apply_sn2 is not None
    names = tree_leaf_names(params["train"])
    assert any(n.startswith("sn2.") for n in names)
    assert len(names) == len(tree_leaves(params["train"]))


@pytest.mark.parametrize("target_name", TARGETS)
def test_eager_rollout_and_kl_grad_match_jax_scan(target_name):
    """The eager DNF rollout (the oracle the kernels' plain versions are
    held to) against JAX's scan: per-chain negative ELBOs, and the KL
    bound's gradient in every leaf (both nets; betas and vd, which reach
    the loss only through the draw and the target term)."""
    case = make_case(target_name)
    neg = scan_neg_elbos(case)
    want_neg = np.asarray(neg(case["jparams"]["train"]))
    got_neg, _ = tb.compute_elbos(case["params"], case["n"], case["ctx"], case["setup"],
                                  **case["draws"])
    np.testing.assert_allclose(got_neg.detach().numpy(), want_neg, atol=W_ATOL, rtol=1e-5)
    want_l, want_g = jax.value_and_grad(lambda t: jnp.mean(neg(t)))(case["jparams"]["train"])
    got_l, got_g = torch_value_and_grad(case, tb.kl_bound)
    np.testing.assert_allclose(got_l, float(want_l), rtol=1e-4)
    assert_grads_close(got_g, want_g, rel=2e-4)
    assert np.linalg.norm(got_g["sn2"]["layers"][0]["w"]) > 0


# --- the plain versions of the kernels against JAX's Pallas kernels ---------

@pytest.mark.parametrize("target_name", TARGETS)
def test_rollout_plain_matches_jax_kernel(target_name):
    """B1's DNF form: the plain version against JAX's fused rollout in
    interpret mode, z, w and the stored trajectory; the CPU wrapper runs
    the plain version and launches nothing."""
    case = make_case(target_name)
    n, k, dim = case["n"], case["k"], case["dim"]
    jz0, jargs, jkw = jax_kernel_args(case)
    z_j, w_j, traj_t = evolve_overdamped_pallas(
        jz0, jnp.zeros(n), *jargs, noise=case["jnoise"], return_trajectory_t=True, **jkw)
    z0, args, kw = port_args(case)
    before = evolve_overdamped_fused.launches
    z, w, traj = evolve_overdamped_fused(z0, torch.zeros(n), *args, noise=case["draws"]["noise"],
                                         return_trajectory=True, **kw)
    assert evolve_overdamped_fused.launches == before
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=Z_ATOL, rtol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=W_ATOL, rtol=1e-5)
    want_traj = np.asarray(traj_t)[:, :dim, :n].transpose(0, 2, 1)
    np.testing.assert_allclose(traj.numpy(), want_traj, atol=Z_ATOL, rtol=1e-5)
    assert torch.equal(traj[0], z0) and torch.equal(traj[k], z)
    # The eager stepper and the plain version: the same function.
    z_e, w_e, _ = tod.evolve_overdamped(z0, args[0], {**tb.merged_params(case["params"])},
                                        case["ctx"], tod.DNF, noise=case["draws"]["noise"])
    np.testing.assert_allclose(z_e.detach().numpy(), z.numpy(), atol=Z_ATOL, rtol=1e-5)
    np.testing.assert_allclose(w_e.detach().numpy(), w.numpy(), atol=W_ATOL, rtol=1e-5)


def _port_sweep_in_jax_layout(case, g):
    """A port sweep's gradient dict in the JAX kernel's layout."""
    p = tb.merged_params(case["params"])
    out = {k: g[k].numpy() for k in ("eps", "betas", "vd_mean", "vd_logdiag")}
    for key in ("sn", "sn2"):
        for name, param in p[key].named_parameters():
            param.grad = g[key][name]
        out[key] = grads_to_numpy(p[key])
    return out


@pytest.mark.parametrize("target_name,eps_schedule", [("gmm", ""), ("many_gmm", ""),
                                                      ("funnel", ""), ("gmm", "cos_sq")])
def test_sweep_plain_matches_jax_sweep_kernel(target_name, eps_schedule):
    """B3's DNF form: the plain sweep against JAX's reverse sweep in
    interpret mode on the trajectory JAX's rollout stored, the same noise
    and cotangents: eps, betas and vd (zeros), both nets' every leaf, and
    dL/dz0. cos_sq: the kernels take a schedule (the setup gives DNF none)."""
    case = make_case(target_name)
    n, k, dim = case["n"], case["k"], case["dim"]
    jz0, jargs, jkw = jax_kernel_args(case)
    jkw["eps_schedule"] = eps_schedule
    _, _, traj_t = evolve_overdamped_pallas(
        jz0, jnp.zeros(n), *jargs, noise=case["jnoise"], return_trajectory_t=True, **jkw)
    noise_t = jnp.zeros((k, _dim_pad(dim), traj_t.shape[2]), jnp.float32).at[
        :, :dim, :n].set(jnp.swapaxes(case["jnoise"], 1, 2))
    cot = case["rng"].standard_normal(n).astype(np.float32)
    g_zfinal = case["rng"].standard_normal((n, dim)).astype(np.float32)
    want, want_z0 = evolve_kl_bwd_pallas(traj_t, noise_t, jnp.asarray(cot), jnp.asarray(g_zfinal),
                                         *jargs[:-1], jod.DNF, n_chains=n, **jkw)
    traj = torch.from_numpy(np.ascontiguousarray(
        np.asarray(traj_t)[:, :dim, :n].transpose(0, 2, 1)))
    _, args, kw = port_args(case)
    before = evolve_kl_bwd.launches
    got, got_z0 = evolve_kl_bwd(traj, case["draws"]["noise"], torch.from_numpy(cot),
                                torch.from_numpy(g_zfinal), *args, eps_schedule=eps_schedule,
                                **kw)
    assert evolve_kl_bwd.launches == before
    assert set(got) == {"eps", "betas", "vd_mean", "vd_logdiag", "sn", "sn2"}
    assert not got["betas"].any() and not got["vd_mean"].any() and not got["vd_logdiag"].any()
    assert_grads_close(_port_sweep_in_jax_layout(case, got), jax.device_get(want), rel=2e-4)
    want_z0 = np.asarray(want_z0)
    assert np.linalg.norm(got_z0.numpy() - want_z0) < 2e-4 * np.linalg.norm(want_z0) + 1e-4
    assert np.linalg.norm(want_z0) > 1.0


def test_sweep_plain_in_float64_agrees_with_float32():
    """The arbiter of two float32 summation orders on the card: the same
    DNF sweep in float64 on the same inputs."""
    case = make_case("many_gmm")
    z0, args, kw = port_args(case)
    _, _, traj, noise = evolve_overdamped_fused_plain(
        z0, torch.zeros(N), *args, noise=case["draws"]["noise"], return_trajectory=True,
        return_noise=True, **kw)
    cot, g_zf = torch.ones(N), torch.randn(N, 2, generator=torch.Generator().manual_seed(1))
    g32, z32 = evolve_kl_bwd_plain(traj, noise, cot, g_zf, *args, **kw)
    g64, z64 = evolve_kl_bwd_plain(traj.double(), noise.double(), cot, g_zf, *args, **kw)
    assert z64.dtype == torch.float64 and g64["sn2"]["emb"].dtype == torch.float64
    flat = lambda g, z: {"eps": g["eps"], "z0": z, **{f"sn.{n}": v for n, v in g["sn"].items()},
                         **{f"sn2.{n}": v for n, v in g["sn2"].items()}}
    want, got = flat(g64, z64), flat(g32, z32)
    for name, w in want.items():
        err = float((got[name].double() - w).norm())
        assert err <= 1e-4 * float(w.norm()) + 1e-5, name


# --- the fused loss, conversion and training --------------------------------

@pytest.mark.parametrize("target_name", TARGETS)
def test_kl_bound_fused_matches_oracle_and_jax_fused(target_name):
    """The custom VJP (plain rollout and sweep on CPU tensors) against the
    eager oracle and against jax.grad of JAX's scan loss: loss and every
    leaf, both nets' included; the draw's gradient too."""
    case = make_case(target_name, n=100)  # 100: no multiple of the chain tiles
    fused_loss = lambda p, n_, c, s, **d: kl_bound_fused(p, n_, c, s, case["target"], **d)
    got_l, got_g = torch_value_and_grad(case, fused_loss)
    oracle_l, oracle_g = torch_value_and_grad(case, tb.kl_bound)
    np.testing.assert_allclose(got_l, oracle_l, rtol=1e-4)
    assert_grads_close(got_g, oracle_g, rel=2e-4)
    want_l, want_g = jax.value_and_grad(lambda t: jnp.mean(scan_neg_elbos(case)(t)))(
        case["jparams"]["train"])
    np.testing.assert_allclose(got_l, float(want_l), rtol=1e-4)
    assert_grads_close(got_g, want_g, rel=2e-4)
    grads = []
    for loss_fn in (fused_loss, tb.kl_bound):
        base = case["draws"]["base_normals"].clone().requires_grad_(True)
        loss, _ = loss_fn(case["params"], case["n"], case["ctx"], case["setup"],
                          base_normals=base, noise=case["draws"]["noise"])
        grads.append(torch.autograd.grad(loss, base)[0].numpy())
    assert np.linalg.norm(grads[0] - grads[1]) < 2e-4 * np.linalg.norm(grads[1]) + 1e-6


def test_kl_bound_fused_matches_jax_kl_bound_pallas():
    """The port's fused loss and JAX's own fused DNF loss (its rollout and
    sweep kernels in interpret mode) on the same weights and noise: the
    base draw differs (JAX draws it from its key), so this holds the JAX
    loss at its own draw against the port's loss at that draw."""
    case = make_case("gmm")
    p = jb.merged_params(case["jparams"])
    z_key, _ = jax.random.split(case["key"])
    jbase = np.asarray(jax.random.normal(z_key, (case["n"], case["dim"])))
    case["draws"]["base_normals"] = torch.from_numpy(jbase)

    def pallas_loss(train_p):
        return kl_bound_pallas(
            {"train": train_p, "notrain": case["jparams"]["notrain"]}, case["key"], case["n"],
            case["jctx"], case["jsetup"], case["jt"], block=128, noise=case["jnoise"],
            interpret=True)[0]

    want_l, want_g = jax.value_and_grad(pallas_loss)(case["jparams"]["train"])
    fused_loss = lambda q, n_, c, s, **d: kl_bound_fused(q, n_, c, s, case["target"], **d)
    got_l, got_g = torch_value_and_grad(case, fused_loss)
    np.testing.assert_allclose(got_l, float(want_l), rtol=1e-4)
    assert_grads_close(got_g, want_g, rel=2e-4)
    assert p["sn2"]["emb"].shape == (K, EMB)


def test_sn2_converts_both_ways_and_trains():
    """sn2 from JAX's tree into a GeffnerNet and back, leaf for leaf in
    JAX's order; its gradient after a fused step comes back in JAX's layout
    beside sn's; a few fused steps move it."""
    case = make_case("gmm")
    back = params_to_numpy(case["params"]["train"])
    want_l, want_def = jax.tree_util.tree_flatten(jax.device_get(case["jparams"]["train"]))
    got_l, got_def = jax.tree_util.tree_flatten(back)
    assert got_def == want_def
    for g, w in zip(got_l, want_l):
        np.testing.assert_array_equal(np.asarray(g, np.float32), np.asarray(w, np.float32))
    train_p = case["params"]["train"]
    for leaf in tree_leaves(train_p):
        leaf.requires_grad_(True)
    loss, _ = kl_bound_fused(case["params"], N, case["ctx"], case["setup"], case["target"],
                             **case["draws"])
    loss.backward()
    g = grads_to_numpy(train_p)
    assert jax.tree_util.tree_structure(g) == want_def
    assert np.linalg.norm(g["sn2"]["layers"][1]["w"]) > 0
    before = params_to_numpy(train_p["sn2"])
    res = train(case["setup"], case["params"], case["ctx"], lr=0.01, iters=3, batch_size=64,
                trainable=case["trainable"], loss_fn=lambda p, n_, c, s, generator=None:
                kl_bound_fused(p, n_, c, s, case["target"], generator=generator))
    after = params_to_numpy(res.params["train"]["sn2"])
    assert not np.allclose(after["head"]["w"], before["head"]["w"])
    assert not np.allclose(after["emb"], before["emb"])


STEPS = 5


def test_five_gmm_cais_flag_steps_match_the_jax_trainer():
    """The gmm_cais flags with the mode swapped to MCD_DNF (K=8, emb 16 here,
    init_eps 0.01, init_sigma 1 as the recipe's, train_vi on, train_eps
    off, lr 1e-3) in both packages' trainers under the same draws, the
    fused KL loss on the port's side: losses and every parameter (sn2's
    included) after five Adam steps."""
    case = make_case("gmm", n=64, k=8, eps=0.01, train_eps=False)
    n, k = case["n"], case["k"]
    rng = np.random.default_rng(11)
    draws = [(rng.standard_normal((n, 2)).astype(np.float32),
              rng.standard_normal((k, n, 2)).astype(np.float32)) for _ in range(STEPS)]
    base_all = jnp.asarray(np.stack([d[0] for d in draws]))
    noise_all = jnp.asarray(np.stack([d[1] for d in draws]))
    key = jax.random.PRNGKey(0)
    step_keys = []
    for _ in range(STEPS):
        key, step_key = jax.random.split(key)
        step_keys.append(step_key)
    step_keys = jnp.stack(step_keys)

    def j_loss(full, step_key, n_, ctx, setup):
        t = jnp.argmax(jnp.all(step_keys == step_key, axis=-1))
        p = jb.merged_params(full)
        z = p["vd"]["mean"] + jnp.exp(p["vd"]["logdiag"]) * base_all[t]
        w = -j_log_prob(p["vd"], z)
        betas = j_betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])
        z, wd, _ = jod.evolve_overdamped(step_key, z, betas, p, ctx, jod.DNF,
                                         noise=noise_all[t])
        neg = -(w + wd + ctx.target_log_prob(z))
        return jnp.mean(neg), (neg, z)

    trainable = case["trainable"]
    assert "eps" not in trainable and "vd" in trainable
    want = jtrainer.train(case["jsetup"], case["jparams"], case["jctx"], lr=1e-3, iters=STEPS,
                          batch_size=n, key=jax.random.PRNGKey(0), trainable=trainable,
                          loss_fn=j_loss, log_every=1, steps_per_call=1)
    step = {"i": 0}

    def loss_fn(params, n_, ctx, setup, generator=None):
        base, noise = draws[step["i"]]
        step["i"] += 1
        return kl_bound_fused(params, n_, ctx, setup, case["target"],
                              base_normals=torch.from_numpy(base), noise=torch.from_numpy(noise))

    got = train(case["setup"], case["params"], case["ctx"], lr=1e-3, iters=STEPS, batch_size=n,
                trainable=trainable, loss_fn=loss_fn, log_every=1)
    assert got.steps_done == STEPS and not got.diverged and not bool(want.diverged)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses), rtol=1e-4)
    got_l, treedef = jax.tree_util.tree_flatten(params_to_numpy(got.params["train"]))
    want_l, want_def = jax.tree_util.tree_flatten(jax.device_get(want.params["train"]))
    assert treedef == want_def
    for g, w in zip(got_l, want_l):
        assert np.linalg.norm(g - w) <= 2e-4 * np.linalg.norm(w) + 1e-7
    start = params_to_numpy(case["params"]["train"])
    assert not np.allclose(params_to_numpy(got.params["train"])["sn2"]["emb"], start["sn2"]["emb"])


GMM_DNF = ("--config.model gmm --config.boundmode MCD_DNF --config.N 64 "
           "--config.nbridges 8 --config.emb_dim 16 --config.init_eps 0.01 "
           "--config.init_sigma 1 --config.train_vi True --config.train_eps False "
           "--config.lr 0.001 --config.iters 30 --noconfig.pretrain_mfvi "
           "--config.n_samples 64 --config.n_input_dist_seeds 3 --config.log.every 1").split()


def test_cli_trains_gmm_dnf_on_cpu_through_the_overdamped_wrappers(monkeypatch, capsys):
    """The gmm_cais flags with MCD_DNF, cut to N=64, emb 16 and 30 steps,
    through the CLI on the CPU: the fused KL loss (DNF's plain rollout and
    sweep, both nets handed to each call) and the fused evaluation, no
    other kernel's wrapper."""
    def refuse(name):
        def fn(*a, **k):
            raise AssertionError(f"the DNF path called {name}")
        return fn

    for module, names in OTHER_WRAPPERS.items():
        for name in names:
            monkeypatch.setattr(module, name, refuse(name))
    calls = {"rollout": 0, "sweep": 0}

    def spy(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            assert a[-1] is tod.DNF
            assert k["sn2"] is not None and k["sn"] is not k["sn2"]
            return fn(*a, **k)
        return wrapped

    rollout = spy("rollout", overdamped.evolve_overdamped_fused)
    monkeypatch.setattr(overdamped, "evolve_overdamped_fused", rollout)
    monkeypatch.setattr(fused_train, "evolve_overdamped_fused", rollout)
    monkeypatch.setattr(fused_train, "evolve_kl_bwd", spy("sweep", kl.evolve_kl_bwd))
    out = run_experiment(parse_flags(GMM_DNF), device="cpu")
    assert "kl_bound_fused, KL reverse sweep" in capsys.readouterr().out
    assert calls == {"rollout": 30 + 3, "sweep": 30}
    result = out["train"]
    assert result.steps_done == 30 and not result.diverged
    assert torch.isfinite(result.losses).all()
    assert np.isfinite(out["final_ln_Z"]) and out["neg_elbos"].shape == (3, 64)
    assert "sn2" in result.params["train"]


# --- the gates and the refusals ---------------------------------------------

def test_gates_take_dnf_with_geffner_nets_at_the_main_path_width():
    """DNF trains and evaluates through the overdamped rollout's and the
    sweep's two-net forms on every target of D 2 and 10, at the main path's
    width (emb 130: in_dim 132 for each net) on many_gmm; the host's
    shared-memory formulas for the two forms."""
    assert "MCD_DNF" in OD_KL_FUSED_MODES <= KL_FUSED_MODES
    for name, dim, k, emb in (("many_gmm", 2, 256, 130), ("gmm", 2, 8, 20),
                              ("funnel", 10, 8, 48)):
        target = load_target(name, device="cpu")
        setup = tb.CMCDSetup(mode="MCD_DNF", dim=dim, nbridges=k, emb_dim=emb)
        assert supports_fused(setup, target) and supports_fused_train(setup, target), name
        loss, words = fused_training_path(setup, 2000)
        assert loss is kl_bound_fused and words == "kl_bound_fused, KL reverse sweep"
    # B1: two W2 and two heads beside one pair of hidden tiles, no constants.
    assert overdamped.smem_bytes(132, 0, 2, nets=2) == 4 * (2 * (132 * 132 + 2 * 132)
                                                           + 2 * 8 * 132 + 3 * 8 * 2)
    assert overdamped.kernel_fits(164, 80, 2, nets=2) and overdamped.kernel_fits(160, 1, 10, nets=2)
    # in_pad 168 at dim 2 (164 at dim 10): two W2 pass the 227 KiB a block may use.
    assert not overdamped.kernel_fits(165, 0, 2, nets=2)
    assert not overdamped.kernel_fits(161, 1, 10, nets=2)
    # B3: the tile (its dW2 slot holds sn2's W2), sn2's head rows and slots,
    # the per-chain buffers, two shares of the input VJP: 201 600 B at four
    # groups, in_dim 132.
    ip, warps, tb_ = 132, 20, 32
    want = 4 * (2 * ip * (ip + 1) + 2 * tb_ * ip + ip * (tb_ + 4) + 2 * ip + 11 * warps
                + 2 * ip + 11 * warps + 15 * tb_ + 2 * warps * 8 * 2)
    assert kl.dnf_smem_bytes(132, 2) == want == 201600
    assert kl.kernel_fits(140, 80, 2, nets=2) and not kl.kernel_fits(141, 80, 2, nets=2)
    assert kl.kernel_fits(132, 1, 10, nets=2) and not kl.kernel_fits(133, 1, 10, nets=2)
    assert not kl.kernel_fits(132, 80, 2, gate=2, nets=2)  # no PIS net in DNF
    too_wide = tb.CMCDSetup(mode="MCD_DNF", dim=2, nbridges=8, emb_dim=150)
    target = load_target("many_gmm", device="cpu")
    assert supports_fused(too_wide, target) and not supports_fused_train(too_wide, target)


@pytest.mark.parametrize("arch", ["dds", "dds_grad"])
def test_dnf_with_a_pis_net_is_refused_before_any_launch(arch):
    """The JAX package fuses no DNF with the PIS nets (pallas_kl.py:158,
    ops/fused.py:163-171): the gates say no, the losses and the wrappers
    raise on either device before anything launches."""
    target = load_target("many_gmm", device="cpu")
    setup = tb.CMCDSetup(mode="MCD_DNF", dim=2, nbridges=8, nn_arch=arch,
                         fully_connected_units=(16, 16))
    assert not supports_fused(setup, target) and not supports_fused_train(setup, target)
    params, ctx = tb.initialize(setup, target.log_prob, device="cpu")
    assert type(params["train"]["sn2"]) is type(params["train"]["sn"])
    before = (evolve_overdamped_fused.launches, evolve_kl_bwd.launches)
    with pytest.raises(NotImplementedError):
        kl_bound_fused(params, 8, ctx, setup, target)
    with pytest.raises(NotImplementedError):
        compute_elbos_fused(params, 8, setup, target)
    p = tb.merged_params(params)
    score = score_for_target(target, "cpu")
    z, w0, betas, vd = torch.zeros(4, 2), torch.zeros(4), torch.ones(8), torch.zeros(2)
    with pytest.raises(NotImplementedError, match="geffner"):
        evolve_overdamped_fused(z, w0, betas, 0.1, vd, vd, score, tod.DNF, dim=2, nbridges=8,
                                sn=p["sn"], sn2=p["sn2"])
    with pytest.raises(NotImplementedError, match="geffner"):
        evolve_kl_bwd(torch.zeros(9, 4, 2), torch.zeros(8, 4, 2), w0, z, betas, 0.1, vd, vd,
                      score, tod.DNF, dim=2, nbridges=8, sn=p["sn"], sn2=p["sn2"])
    assert (evolve_overdamped_fused.launches, evolve_kl_bwd.launches) == before
    # The CLI's gate on the card (main._use_fused), before anything runs there.
    with pytest.raises(NotImplementedError, match="no fused CUDA kernel"):
        _use_fused("training", True, supports_fused_train(setup, target),
                   torch.device("cuda"), setup, target)


def test_dnf_on_the_lgcp_and_without_sn2_is_refused_before_any_launch():
    """On the LGCP only MCD_CAIS_sn takes the wide forms (JAX's split sweep
    excludes sn2, fused_train.py:309-315): DNF is refused there; and a DNF
    call without its second net raises on either device."""
    lgcp = load_target("lgcp", device="cpu")
    setup = tb.CMCDSetup(mode="MCD_DNF", dim=lgcp.dim, nbridges=8, emb_dim=20)
    assert not supports_fused(setup, lgcp) and not supports_fused_train(setup, lgcp)
    assert not fused_train.uses_split_sweep(setup)
    with pytest.raises(NotImplementedError):
        kl_bound_fused({}, 8, None, setup, lgcp)
    with pytest.raises(NotImplementedError, match="no fused CUDA kernel"):
        _use_fused("the evaluation", True, supports_fused(setup, lgcp), torch.device("cuda"),
                   setup, lgcp)
    case = make_case("gmm", n=8, k=4)
    z0, args, kw = port_args(case)
    kw.pop("sn2")
    before = (evolve_overdamped_fused.launches, evolve_kl_bwd.launches)
    with pytest.raises(ValueError, match="sn2"):
        evolve_overdamped_fused(z0, torch.zeros(8), *args, **kw)
    with pytest.raises(ValueError, match="sn2"):
        evolve_kl_bwd(torch.zeros(5, 8, 2), torch.zeros(4, 8, 2), torch.zeros(8),
                      torch.zeros(8, 2), *args, **kw)
    assert (evolve_overdamped_fused.launches, evolve_kl_bwd.launches) == before
    assert fused.kernel_nets(setup) == {"nets": 2}
