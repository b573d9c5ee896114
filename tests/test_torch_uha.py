"""The port's UHA (Uncorrected Hamiltonian Annealing) against the JAX
package, on the CPU, under the same base normals and injected noise (K + 1
rows: the initial momentum's base draw, then one refresh draw per bridge),
on many_gmm, the 3-mode gmm and Neal's funnel (dim 10), with lfsteps 1 and 3.

Layers, each held to the next: the momentum distribution; the eager stepper
(integrators/uha.py) against JAX's scan stepper (z, w and delta_H); the fused
rollout's plain version (ops/uha.py) against the Pallas kernel
evolve_uha_pallas in interpret mode (final state, weight and the three
stores); the reverse sweep's plain version (ops/kl_uha.py) against
evolve_kl_bwd_uha in interpret mode on the same stores and cotangents; the
eager kl_bound under torch.autograd and the custom VJP kl_bound_fused (plain
versions on a CPU tensor) against jax.value_and_grad of the scan loss and of
kl_bound_pallas; five optimizer steps of `train` against the JAX trainer;
the CLI on the CPU, where no other kernel's wrapper is reached.

Tolerances as the JAX suite's: the eager stepper and the plain rollout as
tests/test_pallas_uha.py:44-45 (z 2e-4 abs + 1e-4 rel, w 1e-3 abs + 1e-4
rel); the sweep per leaf within 1e-4 |g| + 1e-6; the losses' gradients
|g_t - g_j| < 2e-4 |g_j| + 1e-4 over the tree and per leaf
(tests/test_pallas_kl.py:370-377), loss rtol 1e-4.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cmcd_tpu
from cmcd_tpu import bounds as jb
from cmcd_tpu.distributions import diag_gaussian_log_prob as j_log_prob
from cmcd_tpu.distributions import momentum_log_prob as j_momentum_log_prob
from cmcd_tpu.integrators import uha as juha
from cmcd_tpu.ops import target_grads as jtg
from cmcd_tpu.ops.fused import _dim_pad
from cmcd_tpu.ops.fused_train import kl_bound_pallas
from cmcd_tpu.ops.pallas_kl import evolve_kl_bwd_uha as j_sweep
from cmcd_tpu.ops.pallas_uha import evolve_uha_pallas
from cmcd_tpu.schedules import betas_from_grid as j_betas_from_grid
from cmcd_tpu.train import trainer as jtrainer
from cmcd_tpu_torch import bounds as tb
from cmcd_tpu_torch import integrators
from cmcd_tpu_torch.distributions import momentum_init, momentum_log_prob
from cmcd_tpu_torch.integrators import uha as tuha
from cmcd_tpu_torch.main import parse_flags, run_experiment
from cmcd_tpu_torch.ops import fused, fused_train, kl_uha, uha
from cmcd_tpu_torch.ops.fused import compute_elbos_fused, supports_fused
from cmcd_tpu_torch.ops.fused_train import (
    KL_FUSED_MODES,
    UHA_KL_FUSED_MODES,
    fused_training_path,
    kl_bound_fused,
    supports_fused_train,
)
from cmcd_tpu_torch.ops.kl_uha import evolve_kl_bwd_uha, evolve_kl_bwd_uha_plain
from cmcd_tpu_torch.ops.target_grads import score_for_target
from cmcd_tpu_torch.ops.uha import MAX_LFSTEPS, evolve_uha_fused
from cmcd_tpu_torch.schedules import betas_from_grid
from cmcd_tpu_torch.targets import load_target
from cmcd_tpu_torch.train import train
from cmcd_tpu_torch.utils.convert import grads_to_numpy, params_from_jax, params_to_numpy
from test_torch_underdamped import from_t
from test_torch_vargrad import assert_grads_close

torch.set_num_threads(1)

K, N = 4, 96
CASES = [("gmm", 1), ("gmm", 3), ("many_gmm", 1), ("many_gmm", 3), ("funnel", 1), ("funnel", 3)]
SIGMA = {"gmm": 5.0, "many_gmm": 8.0, "funnel": 1.0}


def make_uha_case(target_name, lfsteps, eta=0.5, train_md=False, n=N, k=K):
    """One UHA problem in both packages (the sizes and scales of
    tests/test_pallas_kl.py:317-377): eps, eta, vd and the beta knots
    trainable (md too if train_md), non-uniform beta knots, an off-centre
    variational mean, a momentum log-scale away from zero."""
    jt = cmcd_tpu.load_target(target_name)
    dim = jt.dim
    kw = dict(mode="UHA", dim=dim, nbridges=k, lfsteps=lfsteps)
    jsetup = jb.CMCDSetup(**kw)
    trainable = jb.default_trainable("UHA") + (("md",) if train_md else ())
    params, jctx = jb.initialize(jsetup, jt.log_prob, eps=0.05, eta=eta,
                                 init_sigma=SIGMA[target_name], trainable=trainable)
    params["train" if train_md else "notrain"]["md"] = jnp.asarray(
        [(0.1, -0.2)[d % 2] for d in range(dim)], jnp.float32)
    params["train"]["mgridref_y"] = jax.random.uniform(
        jax.random.PRNGKey(4), params["train"]["mgridref_y"].shape, minval=0.5, maxval=1.5)
    params["train"]["vd"]["mean"] = jnp.asarray([0.5 * (-1) ** d for d in range(dim)],
                                                jnp.float32)
    key = jax.random.PRNGKey(0)
    base = np.array(jax.random.normal(jax.random.split(key)[0], (n, dim)))
    rng = np.random.default_rng(2)
    noise = rng.standard_normal((k + 1, n, dim)).astype(np.float32)
    target = load_target(target_name, device="cpu")
    tsetup = tb.CMCDSetup(**kw)
    _, tctx = tb.initialize(tsetup, target.log_prob, device="cpu")
    return {
        "jt": jt, "jsetup": jsetup, "jparams": params, "jctx": jctx, "key": key,
        "jnoise": jnp.asarray(noise), "n": n, "k": k, "lfsteps": lfsteps, "rng": rng, "dim": dim,
        "target": target, "setup": tsetup, "ctx": tctx, "trainable": trainable,
        "params": params_from_jax(jax.device_get(params), device="cpu"),
        "draws": {"base_normals": torch.from_numpy(base), "noise": torch.from_numpy(noise)},
    }


def jax_args(case):
    """z0 and the Pallas kernels' arguments after z0, from JAX's merged
    parameters: (z0, args, kw)."""
    p = jb.merged_params(case["jparams"])
    betas = j_betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])
    z0 = p["vd"]["mean"] + jnp.exp(p["vd"]["logdiag"]) * jnp.asarray(
        case["draws"]["base_normals"].numpy())
    args = (betas, p["eps"], p["eta"], p["md"], p["vd"]["mean"], p["vd"]["logdiag"],
            jtg.grad_t_for_target(case["jt"], _dim_pad(case["dim"])))
    return z0, args, dict(dim=case["dim"], nbridges=case["k"], lfsteps=case["lfsteps"])


def port_args(case):
    """z0 and the port rollout's arguments after z0: (z0, args, kw)."""
    p = tb.merged_params(case["params"])
    betas = betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"]).detach()
    z0 = (p["vd"]["mean"] + torch.exp(p["vd"]["logdiag"])
          * case["draws"]["base_normals"]).detach()
    args = (betas, p["eps"].detach(), p["eta"].detach(), p["md"].detach(),
            p["vd"]["mean"].detach(), p["vd"]["logdiag"].detach(),
            score_for_target(case["target"]))
    return z0, args, dict(dim=case["dim"], nbridges=case["k"], lfsteps=case["lfsteps"])


def test_momentum_distribution_matches_jax():
    rng = np.random.default_rng(0)
    rho = rng.standard_normal((64, 2)).astype(np.float32) * 2.0
    md = np.array([0.3, -0.4], np.float32)
    got = momentum_log_prob(torch.from_numpy(rho), torch.from_numpy(md)).numpy()
    want = np.asarray(j_momentum_log_prob(jnp.asarray(rho), jnp.asarray(md)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    assert torch.equal(momentum_init(3), torch.zeros(3))


@pytest.mark.parametrize("target_name,lfsteps", CASES)
def test_eager_stepper_matches_jax_scan(target_name, lfsteps):
    case = make_uha_case(target_name, lfsteps)
    p = jb.merged_params(case["jparams"])
    z0_j, (betas, *_), _ = jax_args(case)
    z_j, w_j, dh_j = juha.evolve_uha(case["key"], z0_j, betas, p, case["jctx"],
                                     noise=case["jnoise"])
    z0, (betas_t, *_), _ = port_args(case)
    tp = tb.merged_params(case["params"])
    z_t, w_t, dh_t = integrators.evolve(z0, betas_t, tp, case["ctx"], "UHA",
                                        noise=case["draws"]["noise"])
    np.testing.assert_allclose(z_t.detach().numpy(), np.asarray(z_j), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(w_t.detach().numpy(), np.asarray(w_j), atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(dh_t.numpy(), np.asarray(dh_j), atol=1e-3, rtol=1e-4)
    assert dh_t.shape == (K, N) and np.abs(np.asarray(w_j)).max() > 1.0


@pytest.mark.parametrize("target_name,lfsteps", CASES)
def test_rollout_plain_matches_pallas_kernel(target_name, lfsteps):
    case = make_uha_case(target_name, lfsteps)
    z0_j, j_args, j_kw = jax_args(case)
    z_j, w_j, zt, rt, nt = evolve_uha_pallas(z0_j, *j_args, **j_kw, noise=case["jnoise"],
                                             block=128, interpret=True, return_state_t=True)
    z0, args, kw = port_args(case)
    before = evolve_uha_fused.launches
    z, w, zs, rs, ds = evolve_uha_fused(z0, *args, **kw, noise=case["draws"]["noise"],
                                        return_state=True)
    assert evolve_uha_fused.launches == before  # no kernel on a CPU tensor
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=1e-3, rtol=1e-4)
    for got, want in ((zs, zt), (rs, rt), (ds, nt)):
        np.testing.assert_allclose(got.numpy(), from_t(want, N, case["dim"]), atol=2e-4,
                                   rtol=1e-4)
    assert ds is case["draws"]["noise"]  # injected noise is handed on as it is
    # Without stores: the same (z, w).
    z2, w2 = evolve_uha_fused(z0, *args, **kw, noise=case["draws"]["noise"])
    assert torch.equal(z2, z) and torch.equal(w2, w)


@pytest.mark.parametrize("target_name,lfsteps", CASES)
def test_sweep_plain_matches_jax_sweep_kernel(target_name, lfsteps):
    case = make_uha_case(target_name, lfsteps)
    z0_j, j_args, j_kw = jax_args(case)
    _, _, zt, rt, nt = evolve_uha_pallas(z0_j, *j_args, **j_kw, noise=case["jnoise"],
                                         block=128, interpret=True, return_state_t=True)
    cot = case["rng"].standard_normal(N).astype(np.float32)
    g_zfinal = case["rng"].standard_normal((N, case["dim"])).astype(np.float32)
    want, want_z0 = j_sweep(zt, rt, nt, jnp.asarray(cot), jnp.asarray(g_zfinal), *j_args,
                            n_chains=N, block=128, interpret=True, **j_kw)
    _, args, kw = port_args(case)
    stack = lambda x_t: torch.from_numpy(np.ascontiguousarray(from_t(x_t, N, case["dim"])))
    before = evolve_kl_bwd_uha.launches
    got, got_z0 = evolve_kl_bwd_uha(stack(zt), stack(rt), stack(nt), torch.from_numpy(cot),
                                    torch.from_numpy(g_zfinal), *args, **kw)
    assert evolve_kl_bwd_uha.launches == before
    want = jax.device_get(want)
    assert set(got) == set(want)
    for name, w in [*want.items(), ("g_z0", want_z0)]:
        g = (got_z0 if name == "g_z0" else got[name]).numpy()
        w = np.asarray(w)
        assert g.shape == w.shape, name
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w) + 1e-6, name
    assert np.linalg.norm(np.asarray(want["md"])) > 1.0 and np.linalg.norm(want_z0) > 1.0


def test_sweep_plain_in_float64_agrees_with_float32():
    """The arbiter of two float32 summation orders: the same sweep in
    float64 on the same inputs."""
    case = make_uha_case("many_gmm", 3)
    z0, args, kw = port_args(case)
    _, _, zt, rt, dr = evolve_uha_fused(z0, *args, **kw, noise=case["draws"]["noise"],
                                        return_state=True)
    cot, g_zf = torch.ones(N), torch.zeros(N, 2)
    g32, z32 = evolve_kl_bwd_uha_plain(zt, rt, dr, cot, g_zf, *args, **kw)
    g64, z64 = evolve_kl_bwd_uha_plain(zt.double(), rt.double(), dr.double(), cot, g_zf, *args,
                                       **kw)
    assert z64.dtype == torch.float64 and g64["md"].dtype == torch.float64
    for name, want in [*g64.items(), ("z0", z64)]:
        got = z32 if name == "z0" else g32[name]
        assert float((got.double() - want).norm()) <= 1e-4 * float(want.norm()) + 1e-5, name


def scan_loss(case):
    """The mean negative ELBO of the JAX scan stepper
    (tests/test_pallas_kl.py::test_pallas_kl_uha_grad_matches_scan) as a
    function of the trainable tree."""
    params, ctx, key, n = case["jparams"], case["jctx"], case["key"], case["n"]

    def loss(train):
        p = jb.merged_params({"train": train, "notrain": params["notrain"]})
        z_key, evolve_key = jax.random.split(key)
        z = p["vd"]["mean"] + jnp.exp(p["vd"]["logdiag"]) * jax.random.normal(
            z_key, (n, case["dim"]))
        w = -j_log_prob(p["vd"], z)
        betas = j_betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])
        z, wd, _ = juha.evolve_uha(evolve_key, z, betas, p, ctx, noise=case["jnoise"])
        return jnp.mean(-(w + wd + ctx.target_log_prob(z)))

    return loss


def pallas_loss(case):
    def loss(train):
        return kl_bound_pallas(
            {"train": train, "notrain": case["jparams"]["notrain"]}, case["key"], case["n"],
            case["jctx"], case["jsetup"], case["jt"], block=128, noise=case["jnoise"],
            interpret=True)[0]

    return loss


def torch_value_and_grad(case, loss_fn):
    """loss_fn(params, n, ctx, setup, **draws) under autograd: the loss and
    the gradient tree in the JAX layout."""
    train = case["params"]["train"]
    leaves = [train[k] for k in sorted(train) if k != "vd"] + [*train["vd"].values()]
    for leaf in leaves:
        leaf.requires_grad_(True)
        leaf.grad = None
    loss, _ = loss_fn(case["params"], case["n"], case["ctx"], case["setup"], **case["draws"])
    loss.backward()
    return float(loss.detach()), grads_to_numpy(train)


def fused_loss(case):
    return lambda p, n, c, s, **d: kl_bound_fused(p, n, c, s, case["target"], **d)


# (target, lfsteps, eta, md trainable): the three targets, both leapfrog
# lengths, eta at 0 and inside (0, 1), md's gradient checked in three of them.
FUSED_CASES = [("gmm", 1, 0.5, False), ("gmm", 3, 0.0, True),
               ("many_gmm", 1, 0.0, True), ("many_gmm", 3, 0.5, False),
               ("funnel", 1, 0.0, False), ("funnel", 3, 0.5, True)]


@pytest.mark.parametrize("target_name,lfsteps,eta,train_md", FUSED_CASES)
def test_kl_bound_fused_matches_jax_scan_and_pallas(target_name, lfsteps, eta, train_md):
    case = make_uha_case(target_name, lfsteps, eta=eta, train_md=train_md)
    assert supports_fused_train(case["setup"], case["target"])
    got_l, got_g = torch_value_and_grad(case, fused_loss(case))
    assert ("md" in got_g) == train_md
    for jax_loss in (scan_loss(case), pallas_loss(case)):
        want_l, want_g = jax.value_and_grad(jax_loss)(case["jparams"]["train"])
        np.testing.assert_allclose(got_l, float(want_l), rtol=1e-4)
        assert_grads_close(got_g, want_g, rel=2e-4)


@pytest.mark.parametrize("target_name,lfsteps", [("gmm", 3), ("many_gmm", 1), ("funnel", 1)])
def test_eager_kl_bound_grad_matches_jax_scan(target_name, lfsteps):
    case = make_uha_case(target_name, lfsteps, train_md=True)
    want_l, want_g = jax.value_and_grad(scan_loss(case))(case["jparams"]["train"])
    got_l, got_g = torch_value_and_grad(case, tb.kl_bound)
    np.testing.assert_allclose(got_l, float(want_l), rtol=1e-4)
    assert_grads_close(got_g, want_g, rel=2e-4)


def test_md_is_placed_frozen_and_carried_by_the_converter():
    """initialize places md (zeros of dim) for UHA only, outside the
    trainable set as in the JAX package; the converter carries it both ways."""
    target = load_target("gmm", device="cpu")
    setup = tb.CMCDSetup(mode="UHA", dim=2, nbridges=4)
    params, _ = tb.initialize(setup, target.log_prob, trainable=tb.default_trainable("UHA"),
                              device="cpu")
    assert torch.equal(params["notrain"]["md"], torch.zeros(2)) and "md" not in params["train"]
    assert "md" not in tb.default_trainable("UHA") and "sn" not in params["train"]
    other, _ = tb.initialize(tb.CMCDSetup(mode="MCD_U_a-lp", dim=2, nbridges=4),
                             target.log_prob, device="cpu")
    assert "md" not in {**other["train"], **other["notrain"]}
    case = make_uha_case("gmm", 1, train_md=True)
    np.testing.assert_array_equal(params_to_numpy(case["params"])["train"]["md"],
                                  np.asarray(case["jparams"]["train"]["md"]))
    assert grads_to_numpy(case["params"]["train"])["md"].shape == (2,)


def test_compute_elbos_fused_matches_eager_compute_elbos():
    case = make_uha_case("many_gmm", 3)
    want, z_want = tb.compute_elbos(case["params"], N, case["ctx"], case["setup"],
                                    **case["draws"])
    got, z_got = compute_elbos_fused(case["params"], N, case["setup"], case["target"],
                                     **case["draws"])
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(), atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(z_got.numpy(), z_want.detach().numpy(), atol=2e-4, rtol=1e-4)


def test_coverage_and_the_training_path_words():
    assert UHA_KL_FUSED_MODES == {"UHA"} and UHA_KL_FUSED_MODES <= KL_FUSED_MODES
    assert uha.UHA_TARGETS == ("many_gmm", "gmm", "funnel")
    for name in ("many_gmm", "gmm", "funnel"):
        target = load_target(name, device="cpu")
        for lf in (1, MAX_LFSTEPS):
            setup = tb.CMCDSetup(mode="UHA", dim=target.dim, nbridges=256, lfsteps=lf)
            assert supports_fused(setup, target) and supports_fused_train(setup, target)
        loss, words = fused_training_path(setup, 2000)
        assert loss is kl_bound_fused and "UHA" in words
        too_long = tb.CMCDSetup(mode="UHA", dim=target.dim, nbridges=8, lfsteps=MAX_LFSTEPS + 1)
        assert not supports_fused(too_long, target) and not supports_fused_train(too_long, target)
        with pytest.raises(NotImplementedError):
            kl_bound_fused({}, 8, None, too_long, target)
    # The overdamped and the underdamped kernels take the 3-mode gmm too.
    gmm = load_target("gmm", device="cpu")
    for mode in ("MCD_CAIS_var_sn", "MCD_CAIS_sn", "MCD_U_a-lp-sn", "MCD_CAIS_UHA_sn"):
        setup = tb.CMCDSetup(mode=mode, dim=2, nbridges=8, emb_dim=16)
        assert supports_fused(setup, gmm) and supports_fused_train(setup, gmm)


@pytest.mark.parametrize("bad", ["score", "lfsteps", "shape", "noise", "dim"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    case = make_uha_case("gmm", 1)
    z0, (betas, eps, eta, md, mean, logdiag, score), kw = port_args(case)
    stores, noise = torch.zeros(K + 1, N, 2), case["draws"]["noise"]
    if bad == "score":
        score = lambda z: -z
    elif bad == "lfsteps":
        kw["lfsteps"] = MAX_LFSTEPS + 1
    elif bad == "shape":
        z0, stores = z0[:, :1], stores[:K]
    elif bad == "noise":
        noise = noise[1:]
    elif bad == "dim":
        kw["dim"] = 3
    with pytest.raises((NotImplementedError, ValueError)):
        evolve_uha_fused(z0, betas, eps, eta, md, mean, logdiag, score, **kw, noise=noise)
    with pytest.raises((NotImplementedError, ValueError)):
        evolve_kl_bwd_uha(stores, stores, stores if bad != "noise" else noise, torch.zeros(N),
                          torch.zeros(N, 2), betas, eps, eta, md, mean, logdiag, score, **kw)


STEPS = 5


def test_five_uha_steps_match_the_jax_trainer():
    """train in both packages from the same parameters under the same draws,
    the fused UHA loss on the port's side: losses and every parameter after
    five Adam steps (eta moves; md, outside the trainable set, stays)."""
    case = make_uha_case("gmm", 3, n=64)
    n, k = case["n"], case["k"]
    rng = np.random.default_rng(11)
    draws = [(rng.standard_normal((n, 2)).astype(np.float32),
              rng.standard_normal((k + 1, n, 2)).astype(np.float32)) for _ in range(STEPS)]
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
        z, wd, _ = juha.evolve_uha(step_key, z, betas, p, ctx, noise=noise_all[t])
        neg = -(w + wd + ctx.target_log_prob(z))
        return jnp.mean(neg), (neg, z)

    trainable = jb.default_trainable("UHA", train_eps=True, train_vi=False)
    want = jtrainer.train(case["jsetup"], case["jparams"], case["jctx"], lr=0.005, iters=STEPS,
                          batch_size=n, key=jax.random.PRNGKey(0), trainable=trainable,
                          loss_fn=j_loss, log_every=1, steps_per_call=1)
    step = {"i": 0}

    def loss_fn(params, n_, ctx, setup, generator=None):
        base, noise = draws[step["i"]]
        step["i"] += 1
        return kl_bound_fused(params, n_, ctx, setup, case["target"],
                              base_normals=torch.from_numpy(base),
                              noise=torch.from_numpy(noise))

    got = train(case["setup"], case["params"], case["ctx"], lr=0.005, iters=STEPS,
                batch_size=n, trainable=trainable, loss_fn=loss_fn, log_every=1)
    assert got.steps_done == STEPS and not got.diverged and not bool(want.diverged)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses), rtol=1e-4)
    got_l, treedef = jax.tree_util.tree_flatten(params_to_numpy(got.params["train"]))
    want_l, want_def = jax.tree_util.tree_flatten(jax.device_get(want.params["train"]))
    assert treedef == want_def
    for g, w in zip(got_l, want_l):
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w) + 1e-7
    assert float(got.params["train"]["eta"]) != float(case["jparams"]["train"]["eta"])
    assert torch.equal(got.params["notrain"]["md"], case["params"]["notrain"]["md"])


UHA_GMM = ("--config.model gmm --config.boundmode UHA --config.nbridges 8 --config.N 256 "
           "--config.init_eps 0.05 --config.init_eta 0.5 --config.init_sigma 1 "
           "--config.lr 0.001 --config.iters 300 --config.n_samples 256 "
           "--config.n_input_dist_seeds 4 --config.log.every 1 --noconfig.pretrain_mfvi").split()

# Every kernel wrapper that the UHA path must not reach, by the module that
# would reach it.
OTHER_WRAPPERS = {
    fused.overdamped: ["evolve_overdamped_fused"],
    fused.underdamped: ["evolve_underdamped_fused"],
    fused_train: ["evolve_overdamped_fused", "evolve_overdamped_fused_plain",
                  "evolve_underdamped_fused", "evolve_underdamped_fused_plain",
                  "evolve_vargrad_bwd_replay", "evolve_vargrad_bwd_replay_plain",
                  "evolve_vargrad_bwd_reroll", "evolve_vargrad_bwd_reroll_plain",
                  "evolve_kl_bwd", "evolve_kl_bwd_plain", "evolve_kl_bwd_underdamped",
                  "evolve_kl_bwd_underdamped_plain"],
}


def test_cli_trains_gmm_uha_on_cpu_through_the_uha_wrappers_only(tmp_path, monkeypatch, capsys):
    """UHA on the 3-mode gmm through the CLI's phases on the CPU: the fused
    KL loss (plain versions of the UHA rollout and sweep), the fused
    evaluation, the JSONL log with eta; no other kernel's wrapper is called."""
    def refuse(name):
        def fn(*a, **k):
            raise AssertionError(f"the UHA path called {name}")
        return fn

    for module, names in OTHER_WRAPPERS.items():
        for name in names:
            monkeypatch.setattr(module, name, refuse(name))
    calls = {"rollout": 0, "sweep": 0}

    def spy(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(uha, "evolve_uha_fused", spy("rollout", uha.evolve_uha_fused))
    monkeypatch.setattr(fused_train, "evolve_kl_bwd_uha", spy("sweep", kl_uha.evolve_kl_bwd_uha))
    log = tmp_path / "uha.jsonl"
    out = run_experiment(parse_flags(UHA_GMM + ["--config.log.jsonl", str(log)]), device="cpu")
    printed = capsys.readouterr().out
    assert "kl_bound_fused, UHA rollout and UHA reverse sweep" in printed
    assert "Using the fused evaluation path on cpu" in printed
    assert calls == {"rollout": 300 + 4, "sweep": 300}
    result = out["train"]
    assert result.steps_done == 300 and not result.diverged
    losses = result.losses.double()
    assert torch.isfinite(losses).all() and losses[-50:].mean() < losses[:50].mean()
    assert np.isfinite(out["final_ln_Z"]) and out["neg_elbos"].shape == (4, 256)
    lines = [json.loads(line) for line in log.read_text().splitlines()]
    steps = [d for d in lines if "step" in d]
    assert len(steps) >= 10 and all("eta" in d and "eps" in d for d in steps)
    assert steps[-1]["eta"] != 0.5 and "final_ln_Z" in lines[-1]
    assert os.path.getsize(log) > 0
