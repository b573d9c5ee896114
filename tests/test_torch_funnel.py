"""Neal's funnel (dim 10) and the standard normal in the port's overdamped
kernels (ops/overdamped.py, ops/kl.py, ops/vargrad.py), against the JAX
package on the CPU under the same base normals and injected noise.

Layers: the target and its kernel-form score and Hessian product against
JAX (make_funnel, make_funnel_grad_t, jax.hessian in float64); the plain
rollout against the JAX scan integrator for the four overdamped modes; the
plain KL sweep against jax.grad of the scan and the fused KL loss with the
variational draw trained against JAX's scan loss and kl_bound_pallas in
interpret mode; the plain VarGrad replay and re-rolling backward against
JAX's Pallas kernels in interpret mode; five funnel_k8-flag trainer steps
against the JAX trainer; a short CPU run through the CLI; the host's
shared-memory formulas at D = 10; and the refusals of what no kernel is
instantiated for (the underdamped and UHA families on the funnel are held in
tests/test_torch_underdamped.py, test_torch_kl_underdamped.py and
test_torch_uha.py).

Tolerances: the log-density and the score rtol 1e-5 (float32), float64 to
1e-10; the rollout z to 1e-5 and w to 1e-4 absolute; gradients as
tests/test_pallas_kl.py, |g_t - g_j| < 2e-4 |g_j| + 1e-4 over the
flattened tree and per leaf (VarGrad's kernels 1e-4 |g_j| + 1e-4, as
tests/test_pallas_vargrad.py); losses rtol 1e-4; trainer leaves 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

import cmcd_tpu
from cmcd_tpu import bounds as jb
from cmcd_tpu.distributions import diag_gaussian_log_prob as j_log_prob
from cmcd_tpu.integrators import overdamped as jod
from cmcd_tpu.ops.fused import _dim_pad
from cmcd_tpu.ops.fused_train import kl_bound_pallas
from cmcd_tpu.ops.pallas_overdamped import evolve_overdamped_pallas, pack_geffner_t
from cmcd_tpu.ops.pallas_vargrad import evolve_vargrad_bwd_pallas as j_reroll
from cmcd_tpu.ops.pallas_vargrad import evolve_vargrad_bwd_replay as j_replay
from cmcd_tpu.ops.target_grads import (
    grad_t_for_target,
    make_funnel_grad_t,
    make_std_normal_grad_t,
)
from cmcd_tpu.schedules import betas_from_grid as j_betas_from_grid
from cmcd_tpu.targets.funnel import make_funnel as j_make_funnel
from cmcd_tpu.train import trainer as jtrainer
from cmcd_tpu_torch import bounds as tb
from cmcd_tpu_torch.distributions import std_normal_log_prob
from cmcd_tpu_torch.integrators import UNDERDAMPED
from cmcd_tpu_torch.integrators import overdamped as tod
from cmcd_tpu_torch.main import parse_flags, run_experiment
from cmcd_tpu_torch.ops import fused, fused_train, kl, overdamped, uha, underdamped, vargrad
from cmcd_tpu_torch.ops.fused import supports_fused
from cmcd_tpu_torch.ops.fused_train import (
    fused_training_path,
    kl_bound_fused,
    supports_fused_train,
)
from cmcd_tpu_torch.ops.kl import evolve_kl_bwd
from cmcd_tpu_torch.ops.overdamped import evolve_overdamped_fused, evolve_overdamped_fused_plain
from cmcd_tpu_torch.ops.target_grads import (
    TARGETS,
    FunnelScore,
    StdNormalScore,
    kernel_target,
    score_for_target,
)
from cmcd_tpu_torch.ops.vargrad import (
    evolve_vargrad_bwd_replay,
    evolve_vargrad_bwd_reroll_plain,
)
from cmcd_tpu_torch.schedules import betas_from_grid
from cmcd_tpu_torch.targets import Target, load_target
from cmcd_tpu_torch.tools import log_summary
from cmcd_tpu_torch.train import train
from cmcd_tpu_torch.utils.convert import grads_to_numpy, params_from_jax, params_to_numpy
from test_torch_ula import OTHER_WRAPPERS
from test_torch_vargrad import assert_grads_close

torch.set_num_threads(1)

D, K, N, EMB = 10, 5, 96, 16
SPECS = {"MCD_ULA": (tod.ULA, jod.ULA), "MCD_ULA_sn": (tod.ULA_SN, jod.ULA_SN),
         "MCD_CAIS_sn": (tod.CAIS, jod.CAIS), "MCD_CAIS_var_sn": (tod.CAIS_VAR, jod.CAIS_VAR)}
VD_MEAN = np.array([0.4, -0.3, 0.2, -0.1, 0.3, -0.2, 0.1, -0.4, 0.25, -0.15])


def funnel_points(n, seed, v_range=(-3.0, 3.0)):
    """(n, 10) float64 points: v uniform over v_range, x standard normal
    scaled by e^{v/2} (the funnel's own spread at v)."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(*v_range, n)
    x = rng.standard_normal((n, D - 1)) * np.exp(v / 2)[:, None]
    return np.concatenate([v[:, None], x], axis=1)


def test_funnel_log_prob_matches_jax():
    z = funnel_points(64, 0).astype(np.float32)
    got = load_target("funnel", device="cpu").log_prob(torch.from_numpy(z)).numpy()
    want = np.asarray(j_make_funnel().log_prob(jnp.asarray(z)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("v_range", [(-3.0, 3.0), (-20.0, 8.0)])
def test_funnel_score_matches_jax_kernel_form_and_float64_autograd(v_range):
    """The kernel-form score against make_funnel_grad_t (the JAX kernels'
    transposed layout, float32) and against autograd of the port's
    log-density in float64, v down to -20 where e^{-v} is 4.9e8."""
    z64 = funnel_points(64, 1, v_range)
    score = score_for_target(load_target("funnel", device="cpu"))
    assert isinstance(score, FunnelScore) and (score.dim, score.sig) == (D, 3.0)
    z32 = z64.astype(np.float32)
    grad_t = make_funnel_grad_t(D, _dim_pad(D))
    z_t = jnp.zeros((_dim_pad(D), 64)).at[:D].set(jnp.asarray(z32).T)
    want32 = np.asarray(grad_t(z_t))[:D].T
    got32 = score(torch.from_numpy(z32)).numpy()
    np.testing.assert_allclose(got32, want32, rtol=1e-5, atol=1e-5 * np.abs(want32).max())
    zt = torch.from_numpy(z64).requires_grad_(True)
    (want64,) = torch.autograd.grad(load_target("funnel", device="cpu").log_prob(zt).sum(), zt)
    got64 = score(torch.from_numpy(z64))
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy(), want64.numpy(), rtol=1e-10,
                               atol=1e-10 * float(want64.abs().max()))


def test_funnel_hvp_matches_float64_jax_hessian():
    """(H u) written out against jax.hessian of JAX's funnel log-density in
    float64 at points with v in [-20, 8]."""
    z = funnel_points(24, 2, (-20.0, 8.0))
    u = np.random.default_rng(3).standard_normal((24, D))
    with enable_x64(True):
        log_p = j_make_funnel().log_prob
        hess = jax.vmap(jax.hessian(lambda x: log_p(x[None])[0]))(jnp.asarray(z, jnp.float64))
        want = np.einsum("nij,nj->ni", np.asarray(hess), u)
    got = FunnelScore(dim=D, sig=3.0).hvp(torch.from_numpy(z), torch.from_numpy(u)).numpy()
    for g, w in zip(got, want):
        assert np.linalg.norm(g - w) <= 1e-10 * np.linalg.norm(w) + 1e-12


def test_std_normal_score_and_hvp():
    """The closed-form check: score -z (JAX's make_std_normal_grad_t), H u = -u,
    and the score of the port's std_normal_log_prob."""
    z = np.random.default_rng(4).standard_normal((32, D)).astype(np.float32)
    score = score_for_target(Target("std_normal", D, std_normal_log_prob))
    assert isinstance(score, StdNormalScore) and score.dim == D
    z_t = jnp.zeros((_dim_pad(D), 32)).at[:D].set(jnp.asarray(z).T)
    want = np.asarray(make_std_normal_grad_t(D, _dim_pad(D))(z_t))[:D].T
    got = score(torch.from_numpy(z))
    np.testing.assert_array_equal(got.numpy(), want)
    zt = torch.from_numpy(z).requires_grad_(True)
    (auto,) = torch.autograd.grad(std_normal_log_prob(zt).sum(), zt)
    np.testing.assert_allclose(got.numpy(), auto.numpy(), rtol=1e-6)
    u = torch.from_numpy(z[::-1].copy())
    assert torch.equal(score.hvp(torch.from_numpy(z), u), -u)
    code, tpar, inv_var = kernel_target(score, "cpu")
    assert (code, tpar.tolist(), inv_var) == (TARGETS["std_normal"], [1.0], 0.0)
    code, tpar, _ = kernel_target(FunnelScore(dim=D, sig=3.0), "cpu")
    assert (code, tpar.tolist()) == (TARGETS["funnel"], [3.0])


def make_case(mode, n=N, k=K, eps=0.1, eps_schedule="cos_sq", grad_clipping=False,
              train_eps=True):
    """One funnel problem in both packages: eps (if asked), vd and the beta
    knots trainable, non-uniform knots, an off-centre variational mean;
    a net with factor_sn 0.3 and a random head where the mode has one."""
    jt = cmcd_tpu.load_target("funnel")
    kw = dict(mode=mode, dim=D, nbridges=k, emb_dim=EMB, grad_clipping=grad_clipping,
              eps_schedule=eps_schedule)
    jsetup = jb.CMCDSetup(**kw)
    trainable = jb.default_trainable(mode, train_eps=train_eps, train_vi=True)
    params, jctx = jb.initialize(jsetup, jt.log_prob, eps=eps, init_sigma=1.0,
                                 trainable=trainable)
    if "sn" in params["train"]:
        sn = params["train"]["sn"]
        sn["factor_sn"] = jnp.asarray(0.3)
        sn["head"]["w"] = 0.05 * jax.random.normal(jax.random.PRNGKey(9), sn["head"]["w"].shape)
    params["train"]["mgridref_y"] = jax.random.uniform(
        jax.random.PRNGKey(4), params["train"]["mgridref_y"].shape, minval=0.5, maxval=1.5)
    params["train"]["vd"]["mean"] = jnp.asarray(VD_MEAN, jnp.float32)
    rng = np.random.default_rng(2)
    base = rng.standard_normal((n, D)).astype(np.float32)
    noise = rng.standard_normal((k, n, D)).astype(np.float32)
    target = load_target("funnel", device="cpu")
    tsetup = tb.CMCDSetup(**kw)
    _, tctx = tb.initialize(tsetup, target.log_prob, device="cpu")
    return {
        "jt": jt, "jsetup": jsetup, "jparams": params, "jctx": jctx, "key": jax.random.PRNGKey(0),
        "jnoise": jnp.asarray(noise), "jbase": jnp.asarray(base), "n": n, "k": k, "rng": rng,
        "mode": mode, "target": target, "setup": tsetup, "ctx": tctx, "trainable": trainable,
        "params": params_from_jax(jax.device_get(params), device="cpu"),
        "draws": {"base_normals": torch.from_numpy(base), "noise": torch.from_numpy(noise)},
    }


def port_args(case):
    """(z0, the port rollout's arguments after w0, its keywords)."""
    p = tb.merged_params(case["params"])
    betas = betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"]).detach()
    z0 = (p["vd"]["mean"] + torch.exp(p["vd"]["logdiag"]) * case["draws"]["base_normals"]).detach()
    args = (betas, p["eps"].detach(), p["vd"]["mean"].detach(), p["vd"]["logdiag"].detach(),
            score_for_target(case["target"]), SPECS[case["mode"]][0])
    s = case["setup"]
    kw = dict(dim=D, nbridges=case["k"], sn=p.get("sn"), eps_schedule=s.eps_schedule,
              grad_clipping=s.grad_clipping)
    return z0, args, kw


def jax_rollout(case):
    """The JAX scan integrator as a function of (theta, z0): (z_K, w_delta)."""
    p = jb.merged_params(case["jparams"])
    spec = SPECS[case["mode"]][1]

    def run(theta, z0):
        q = dict(p, eps=theta["eps"], vd={"mean": theta["vd_mean"],
                                          "logdiag": theta["vd_logdiag"]})
        if "sn" in theta:
            q["sn"] = theta["sn"]
        z, w, _ = jod.evolve_overdamped(case["key"], z0, theta["betas"], q, case["jctx"], spec,
                                        noise=case["jnoise"])
        return z, w

    theta = {"eps": p["eps"], "betas": j_betas_from_grid(p["mgridref_y"], p["gridref_x"],
                                                         p["target_x"]),
             "vd_mean": p["vd"]["mean"], "vd_logdiag": p["vd"]["logdiag"]}
    if "sn" in p:
        theta["sn"] = p["sn"]
    z0 = p["vd"]["mean"] + jnp.exp(p["vd"]["logdiag"]) * case["jbase"]
    return run, theta, z0


@pytest.mark.parametrize("mode", ["MCD_CAIS_sn", "MCD_CAIS_var_sn", "MCD_ULA_sn", "MCD_ULA"])
def test_plain_rollout_matches_jax_scan(mode):
    """Every overdamped form at D = 10 under cos_sq (ULA's setup drops the
    schedule, as JAX's does)."""
    case = make_case(mode)
    run, theta, z0_j = jax_rollout(case)
    z_j, w_j = run(theta, z0_j)
    z0, args, kw = port_args(case)
    before = evolve_overdamped_fused.launches
    z, w = evolve_overdamped_fused(z0, torch.zeros(N), *args, noise=case["draws"]["noise"], **kw)
    assert evolve_overdamped_fused.launches == before  # no kernel on a CPU tensor
    assert z.shape == (N, D)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=1e-4, rtol=0)


def _port_grads_in_jax_layout(case, g):
    out = {k: g[k].numpy() for k in ("eps", "betas", "vd_mean", "vd_logdiag")}
    sn = tb.merged_params(case["params"]).get("sn")
    if sn is not None:
        for name, p in sn.named_parameters():
            p.grad = g["sn"][name]
        out["sn"] = grads_to_numpy(sn)
    return out


@pytest.mark.parametrize("mode", ["MCD_CAIS_sn", "MCD_ULA_sn", "MCD_ULA"])
def test_sweep_plain_matches_jax_grad_of_the_scan(mode):
    """sum_n [c_n w_delta_n + g_n . z_K] in theta and z0: the plain sweep on
    the plain rollout's path against jax.grad through the scan."""
    case = make_case(mode)
    run, theta, z0_j = jax_rollout(case)
    cot = case["rng"].standard_normal(N).astype(np.float32)
    g_zf = case["rng"].standard_normal((N, D)).astype(np.float32)

    def objective(theta, z0):
        z, w = run(theta, z0)
        return jnp.sum(cot * w) + jnp.sum(g_zf * z)

    want, want_z0 = jax.grad(objective, argnums=(0, 1))(theta, z0_j)
    z0, args, kw = port_args(case)
    _, _, traj, noise = evolve_overdamped_fused_plain(
        z0, torch.zeros(N), *args, noise=case["draws"]["noise"], return_trajectory=True,
        return_noise=True, **kw)
    before = evolve_kl_bwd.launches
    got, got_z0 = evolve_kl_bwd(traj, noise, torch.from_numpy(cot), torch.from_numpy(g_zf),
                                *args, **kw)
    assert evolve_kl_bwd.launches == before
    assert_grads_close(_port_grads_in_jax_layout(case, got), jax.device_get(want), rel=2e-4)
    want_z0 = np.asarray(want_z0)
    assert np.linalg.norm(got_z0.numpy() - want_z0) < 2e-4 * np.linalg.norm(want_z0) + 1e-4


def torch_value_and_grad(case, loss_fn):
    train = case["params"]["train"]
    leaves = [train[k] for k in ("eps", "eta", "gamma", "mgridref_y") if k in train]
    leaves += [*train["vd"].values()]
    if "sn" in train:
        leaves += [*train["sn"].parameters()]
    for leaf in leaves:
        leaf.requires_grad_(True)
        leaf.grad = None
    loss, _ = loss_fn(case["params"], case["n"], case["ctx"], case["setup"], **case["draws"])
    loss.backward()
    return float(loss.detach()), grads_to_numpy(train)


def jax_scan_loss(case):
    spec = SPECS[case["mode"]][1]

    def loss(train):
        p = jb.merged_params({"train": train, "notrain": case["jparams"]["notrain"]})
        z = p["vd"]["mean"] + jnp.exp(p["vd"]["logdiag"]) * case["jbase"]
        w = -j_log_prob(p["vd"], z)
        betas = j_betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])
        z, wd, _ = jod.evolve_overdamped(case["key"], z, betas, p, case["jctx"], spec,
                                         noise=case["jnoise"])
        return jnp.mean(-(w + wd + case["jctx"].target_log_prob(z)))

    return loss


def test_kl_bound_fused_with_train_vi_matches_jax_scan_and_pallas():
    """funnel_k8's loss (MCD_CAIS_sn, cos_sq, train_vi) at N=128: loss and
    every leaf, vd's included, against JAX's scan loss and its fused Pallas
    loss in interpret mode (the case of tests/test_pallas_kl.py:74)."""
    case = make_case("MCD_CAIS_sn", n=128)
    n = case["n"]
    fused_loss = lambda p, n_, c, s, **d: kl_bound_fused(p, n_, c, s, case["target"], **d)
    got_l, got_g = torch_value_and_grad(case, fused_loss)
    want_l, want_g = jax.value_and_grad(jax_scan_loss(case))(case["jparams"]["train"])
    np.testing.assert_allclose(got_l, float(want_l), rtol=1e-4)
    assert_grads_close(got_g, want_g, rel=2e-4)
    assert np.linalg.norm(got_g["vd"]["mean"]) > 1e-3  # train_vi: a live vd gradient

    z_key = jax.random.split(case["key"])[0]
    case["draws"]["base_normals"] = torch.from_numpy(
        np.array(jax.random.normal(z_key, (n, D)), np.float32))

    def pallas_loss(train):
        return kl_bound_pallas({"train": train, "notrain": case["jparams"]["notrain"]},
                               case["key"], n, case["jctx"], case["jsetup"], case["jt"],
                               block=128, noise=case["jnoise"], interpret=True)[0]

    got_l, got_g = torch_value_and_grad(case, fused_loss)
    want_l, want_g = jax.value_and_grad(pallas_loss)(case["jparams"]["train"])
    np.testing.assert_allclose(got_l, float(want_l), rtol=1e-4)
    assert_grads_close(got_g, want_g, rel=2e-4)


def _jax_vargrad_args(case, z0):
    """JAX's VarGrad kernels' arguments for the case (interpret mode) and
    the trajectory its fused rollout stores, transposed."""
    p = jb.merged_params(case["jparams"])
    s = case["jsetup"]
    dim_pad = _dim_pad(D)
    betas = j_betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])
    sn_w, sn_meta = pack_geffner_t(p["sn"], D, dim_pad)
    args = (betas, p["eps"], p["vd"]["mean"], p["vd"]["logdiag"],
            grad_t_for_target(case["jt"], dim_pad), jod.CAIS_VAR)
    kw = dict(dim=D, nbridges=case["k"], sn_weights=sn_w, sn_meta=sn_meta,
              eps_schedule=s.eps_schedule, grad_clipping=s.grad_clipping, block=128,
              interpret=True)
    _, _, traj_t = evolve_overdamped_pallas(z0, jnp.zeros(case["n"]), *args,
                                            noise=case["jnoise"], return_trajectory_t=True, **kw)
    return args, kw, traj_t


def test_vargrad_plain_backwards_match_jax_kernels():
    """The replay backward's plain version on JAX's stored trajectory and
    the re-rolling one from z0 under the same noise, against JAX's replay
    and re-rolling Pallas kernels in interpret mode (N=128)."""
    case = make_case("MCD_CAIS_var_sn", n=128)
    n = case["n"]
    _, theta, z0_j = jax_rollout(case)
    j_args, j_kw, traj_t = _jax_vargrad_args(case, z0_j)
    cot = case["rng"].standard_normal(n).astype(np.float32)
    z0, args, kw = port_args(case)
    traj = torch.from_numpy(np.ascontiguousarray(np.asarray(traj_t)[:, :D, :n].transpose(0, 2, 1)))
    np.testing.assert_allclose(traj[0].numpy(), z0.numpy(), atol=1e-6)
    want = j_replay(traj_t, jnp.asarray(cot), *j_args, n_chains=n, **j_kw)
    before = evolve_vargrad_bwd_replay.launches
    got = evolve_vargrad_bwd_replay(traj, torch.from_numpy(cot), *args, **kw)
    assert evolve_vargrad_bwd_replay.launches == before
    assert_grads_close(_port_grads_in_jax_layout(case, got), jax.device_get(want))
    want = j_reroll(z0_j, jnp.asarray(cot), *j_args, noise=case["jnoise"], **j_kw)
    got = evolve_vargrad_bwd_reroll_plain(z0, torch.from_numpy(cot), *args,
                                          noise=case["draws"]["noise"], **kw)
    assert_grads_close(_port_grads_in_jax_layout(case, got), jax.device_get(want))


STEPS = 5


def test_five_funnel_k8_steps_match_the_jax_trainer():
    """funnel_k8's flags (MCD_CAIS_sn, K=8, cos_sq, init_eps 0.1, init_sigma
    1, train_vi on, train_eps off, lr 0.01) at N=64, emb 16 in both
    packages' trainers under the same draws, the fused KL loss on the port's
    side: losses and every parameter after five Adam steps."""
    case = make_case("MCD_CAIS_sn", n=64, k=8, eps=0.1, train_eps=False)
    n, k = case["n"], case["k"]
    rng = np.random.default_rng(11)
    draws = [(rng.standard_normal((n, D)).astype(np.float32),
              rng.standard_normal((k, n, D)).astype(np.float32)) for _ in range(STEPS)]
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
        z, wd, _ = jod.evolve_overdamped(step_key, z, betas, p, ctx, jod.CAIS,
                                         noise=noise_all[t])
        neg = -(w + wd + ctx.target_log_prob(z))
        return jnp.mean(neg), (neg, z)

    trainable = case["trainable"]
    assert "eps" not in trainable and "vd" in trainable
    want = jtrainer.train(case["jsetup"], case["jparams"], case["jctx"], lr=0.01, iters=STEPS,
                          batch_size=n, key=jax.random.PRNGKey(0), trainable=trainable,
                          loss_fn=j_loss, log_every=1, steps_per_call=1)
    step = {"i": 0}

    def loss_fn(params, n_, ctx, setup, generator=None):
        base, noise = draws[step["i"]]
        step["i"] += 1
        return kl_bound_fused(params, n_, ctx, setup, case["target"],
                              base_normals=torch.from_numpy(base), noise=torch.from_numpy(noise))

    got = train(case["setup"], case["params"], case["ctx"], lr=0.01, iters=STEPS,
                batch_size=n, trainable=trainable, loss_fn=loss_fn, log_every=1)
    assert got.steps_done == STEPS and not got.diverged and not bool(want.diverged)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses), rtol=1e-4)
    got_l, treedef = jax.tree_util.tree_flatten(params_to_numpy(got.params["train"]))
    want_l, want_def = jax.tree_util.tree_flatten(jax.device_get(want.params["train"]))
    assert treedef == want_def
    # Adam's per-step division by the gradient's running scale carries
    # float32 rounding of the gradients into the parameters (see the
    # gmm_ula case in tests/test_torch_ula.py): 2e-4 per leaf.
    for g, w in zip(got_l, want_l):
        assert np.linalg.norm(g - w) <= 2e-4 * np.linalg.norm(w) + 1e-7
    assert not np.allclose(params_to_numpy(got.params["train"])["vd"]["mean"], VD_MEAN)


FUNNEL_K8 = ("--config.model funnel --config.boundmode MCD_CAIS_sn --config.N 64 "
             "--config.nbridges 8 --config.emb_dim 16 --config.init_sigma 1 "
             "--config.train_vi True --config.train_eps False --config.eps_schedule cos_sq "
             "--config.iters 40 --noconfig.pretrain_mfvi --config.n_samples 128 "
             "--config.n_input_dist_seeds 4 --config.log.every 1 "
             "--config.steps_per_call 10").split()


def test_cli_trains_the_funnel_on_cpu_through_the_overdamped_wrappers(tmp_path, monkeypatch,
                                                                       capsys):
    """funnel_k8's flags, cut to N=64, emb 16 and 40 steps, through the CLI on
    the CPU: FUNNEL_EPS_DICT[8] sets init_eps 0.1 and lr 0.01; the fused KL
    loss (plain rollout and sweep) and the fused evaluation, no other
    kernel's wrapper; tools/log_summary reads the JSONL log back."""
    def refuse(name):
        def fn(*a, **k):
            raise AssertionError(f"the funnel path called {name}")
        return fn

    for module, names in OTHER_WRAPPERS.items():
        for name in names:
            monkeypatch.setattr(module, name, refuse(name))
    calls = {"rollout": 0, "sweep": 0}

    def spy(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            assert a[0].shape[-1] == D
            return fn(*a, **k)
        return wrapped

    rollout = spy("rollout", overdamped.evolve_overdamped_fused)
    monkeypatch.setattr(overdamped, "evolve_overdamped_fused", rollout)
    monkeypatch.setattr(fused_train, "evolve_overdamped_fused", rollout)
    monkeypatch.setattr(fused_train, "evolve_kl_bwd", spy("sweep", kl.evolve_kl_bwd))
    log = tmp_path / "funnel.jsonl"
    cfg = parse_flags(FUNNEL_K8 + ["--config.log.jsonl", str(log)])
    out = run_experiment(cfg, device="cpu")
    printed = capsys.readouterr().out
    assert "kl_bound_fused, KL reverse sweep" in printed
    assert (cfg.init_eps, cfg.lr) == (0.1, 0.01)
    assert calls == {"rollout": 40 + 4, "sweep": 40}
    result = out["train"]
    assert result.steps_done == 40 and not result.diverged
    assert torch.isfinite(result.losses).all()
    assert np.isfinite(out["final_ln_Z"]) and out["neg_elbos"].shape == (4, 128)
    assert out["samples"].shape == (4 * 128, D)
    summary = log_summary.summarise(str(log))
    assert summary["final_elbo"] == out["final_elbo"] and summary["last_step"] == 39


def test_host_limits_at_dim_10():
    """The shared-memory formulas the wrappers hold against the kernels'
    (ops/*._library), at funnel_k8's in_dim 58 (in_pad 60, one float of
    target constants): rollout 60^2 + 2*8*60 + 10*60 + 4 + 3*8*10 floats;
    the backward tile at four groups 2*60*61 + 2*32*60 + 60*36 + 10*60 + 4
    + 35*20, plus per chain 41 (VarGrad) or 71 floats and per warp 80 (the
    KL sweep); len_a 58^2 + 21*58 + 33."""
    assert overdamped.smem_bytes(58, 1, 10) == 4 * 5404
    assert vargrad.tile_floats(4, 58, 1, 10) == 14624
    assert vargrad.smem_bytes(58, 1, 4, dim=10) == 4 * (14624 + 41 * 32)
    assert kl.extra_floats(10) == (71, 80)
    assert (vargrad.smem_bytes(58, 1, 4, kl.extra_floats(10), dim=10)
            == 4 * (14624 + 71 * 32 + 1600))
    assert vargrad.len_a(58, 10) == 4615 and vargrad.len_a(132, 2) == 132 * 132 + 5 * 132 + 9
    assert kl.ula_len_sums(10) == 21
    # The D head rows and vectors cost shared memory: the widest nets that
    # fit shrink at D = 10 (rollout 232 -> 224, KL sweep 144 -> 136, VarGrad
    # 144 -> 140 features, with one float of target constants).
    for dim, rollout, sweep, var in ((2, 232, 144, 144), (10, 224, 136, 140)):
        assert overdamped.kernel_fits(rollout, 1, dim) and not overdamped.kernel_fits(
            rollout + 1, 1, dim)
        assert kl.kernel_fits(sweep, 1, dim) and not kl.kernel_fits(sweep + 1, 1, dim)
        assert vargrad.kernel_fits(var, 1, dim) and not vargrad.kernel_fits(var + 1, 1, dim)


def test_assemble_grads_reads_the_dim_10_layout():
    """A backward kernel's sums at D = 10 (csrc/cmcd_tile.cuh: dW2, dheadW
    (10 x in), db2, dW1[:10], then eps, vd mean (10), vd logdiag (10),
    factor, headb (10)) land in the leaves of those names."""
    case = make_case("MCD_CAIS_sn")
    sn = tb.merged_params(case["params"])["sn"]
    in_dim, k = sn.in_dim, case["k"]
    out_a = torch.arange(vargrad.len_a(in_dim, D), dtype=torch.float32)
    out_b = torch.zeros(k + 1, vargrad.len_b(in_dim))
    g = vargrad.assemble_grads(out_a, out_b, sn, D, k)
    sq = in_dim * in_dim
    s0 = sq + (2 * D + 1) * in_dim
    assert torch.equal(g["sn"]["head.weight"].reshape(-1), out_a[sq:sq + D * in_dim])
    assert torch.equal(g["sn"]["layers.1.bias"], out_a[sq + D * in_dim:sq + (D + 1) * in_dim])
    assert float(g["eps"]) == s0 and g["vd_mean"].tolist() == list(range(s0 + 1, s0 + 11))
    assert g["vd_logdiag"].tolist() == list(range(s0 + 11, s0 + 21))
    assert float(g["sn"]["factor_sn"]) == s0 + 21
    assert g["sn"]["head.bias"].tolist() == list(range(s0 + 22, s0 + 32))
    assert len(out_a) == s0 + 33  # and gamma's slot last


def test_refusals_before_any_launch():
    """Every family takes the funnel (the overdamped modes, the seven
    underdamped ones and UHA); what stays refused, on both devices and
    before anything launches: the standard normal in the underdamped and UHA
    kernels (their instances are the recipes' three targets), gmm at dim 10,
    a funnel of another funnel_d, MCD_DNF with a PIS net (DNF itself runs on
    the funnel through the two-net forms, instantiated at D = 10)."""
    funnel = load_target("funnel", device="cpu")
    for mode in ("MCD_CAIS_sn", "MCD_ULA_sn", "MCD_ULA", "MCD_CAIS_var_sn", "MCD_U_a-lp-sn",
                 "MCD_U_e-lp", "MCD_U_ea-lp-sn", "MCD_CAIS_UHA_sn", "UHA"):
        setup = tb.CMCDSetup(mode=mode, dim=D, nbridges=8, emb_dim=48)
        assert supports_fused(setup, funnel) and supports_fused_train(setup, funnel)
    assert fused_training_path(tb.CMCDSetup(mode="MCD_CAIS_sn", dim=D, nbridges=8), 300)[1] \
        == "kl_bound_fused, KL reverse sweep"
    dnf = tb.CMCDSetup(mode="MCD_DNF", dim=D, nbridges=8, emb_dim=48)
    assert supports_fused(dnf, funnel) and supports_fused_train(dnf, funnel)
    assert not supports_fused(tb.CMCDSetup(mode="MCD_DNF", dim=D, nbridges=8,
                                           nn_arch="dds_grad", fully_connected_units=(16, 16)),
                              funnel)
    score, normal = FunnelScore(dim=D, sig=3.0), StdNormalScore(dim=D)
    z = torch.zeros(4, D)
    with pytest.raises(NotImplementedError, match="B11"):
        uha.check_config("UHA", normal, D, 8, 1)
    before = underdamped.evolve_underdamped_fused.launches
    for bad_score, err in ((normal, NotImplementedError), (FunnelScore(dim=12, sig=3.0),
                                                           ValueError)):
        with pytest.raises(err, match="B11|dim must be"):
            underdamped.evolve_underdamped_fused(
                torch.zeros(4, bad_score.dim), torch.zeros(4), torch.ones(8), 0.1, 1.0, 0.5,
                torch.zeros(bad_score.dim), torch.zeros(bad_score.dim), bad_score,
                UNDERDAMPED["MCD_U_a-lp-sn"], dim=bad_score.dim, nbridges=8)
    assert underdamped.evolve_underdamped_fused.launches == before
    underdamped.evolve_underdamped_fused(
        z, torch.zeros(4), torch.ones(8), 0.1, 1.0, 0.5, torch.zeros(D), torch.zeros(D),
        score, UNDERDAMPED["MCD_U_a-lp"], dim=D, nbridges=8)  # the funnel runs (plain, CPU)
    before = evolve_overdamped_fused.launches
    gmm = score_for_target(load_target("gmm", device="cpu"))
    for bad_score, bad_dim in ((gmm, D), (FunnelScore(dim=12, sig=3.0), 12), (score, 2)):
        with pytest.raises(ValueError, match="dim must be"):
            evolve_overdamped_fused(torch.zeros(4, bad_dim), torch.zeros(4), torch.ones(8), 0.1,
                                    torch.zeros(bad_dim), torch.zeros(bad_dim), bad_score,
                                    tod.ULA, dim=bad_dim, nbridges=8)
    assert evolve_overdamped_fused.launches == before
    wide = load_target("funnel", type("C", (), {"funnel_d": 12})(), device="cpu")
    assert wide.dim == 12 and score_for_target(wide).dim == 12
    assert not supports_fused(tb.CMCDSetup(mode="MCD_ULA", dim=12, nbridges=8), wide)
    assert not supports_fused(tb.CMCDSetup(mode="MCD_ULA", dim=D, nbridges=8),
                              load_target("gmm", device="cpu"))
    assert fused.net_width(tb.CMCDSetup(mode="MCD_CAIS_sn", dim=D, nbridges=8, emb_dim=48)) == 58
