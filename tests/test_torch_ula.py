"""Plain ULA, ULA_sn and the 3-mode gmm in the port's overdamped kernels
(ops/overdamped.py, ops/kl.py), against the JAX package on the CPU under the
same base normals and injected noise.

Four layers: the plain rollout against the JAX scan integrator
(evolve_overdamped) for ULA and ULA_sn on both targets; the plain reverse
sweep against jax.grad of that scan (the sum of the log-weight increments
and the final state under random cotangents, in theta and in z0); the
fused KL loss (plain versions on CPU tensors) with the variational draw
trained against JAX's scan loss and kl_bound_pallas in interpret mode, in
the cases of tests/test_pallas_kl.py:72-77 that this slice covers and the
3-mode gmm under MCD_CAIS_sn; five trainer steps of the gmm_ula recipe's
flags against the JAX trainer.

Tolerances: the rollout z to 1e-5 and w to 1e-4 absolute; gradients as
tests/test_pallas_kl.py, |g_t - g_j| < 2e-4 |g_j| + 1e-4 over the flattened
tree and per leaf; losses rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cmcd_tpu
from cmcd_tpu import bounds as jb
from cmcd_tpu.distributions import diag_gaussian_log_prob as j_log_prob
from cmcd_tpu.integrators import overdamped as jod
from cmcd_tpu.ops.fused_train import kl_bound_pallas
from cmcd_tpu.schedules import betas_from_grid as j_betas_from_grid
from cmcd_tpu.train import trainer as jtrainer
from cmcd_tpu_torch import bounds as tb
from cmcd_tpu_torch.integrators import overdamped as tod
from cmcd_tpu_torch.main import parse_flags, run_experiment
from cmcd_tpu_torch.ops import fused, fused_train, kl, overdamped
from cmcd_tpu_torch.ops.fused import compute_elbos_fused, supports_fused
from cmcd_tpu_torch.ops.fused_train import (
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
from cmcd_tpu_torch.tools import log_summary
from cmcd_tpu_torch.train import train
from cmcd_tpu_torch.utils.convert import grads_to_numpy, params_from_jax, params_to_numpy
from test_torch_vargrad import assert_grads_close

torch.set_num_threads(1)

K, N, EMB = 5, 96, 16
SPECS = {"MCD_ULA": (tod.ULA, jod.ULA), "MCD_ULA_sn": (tod.ULA_SN, jod.ULA_SN),
         "MCD_CAIS_sn": (tod.CAIS, jod.CAIS), "MCD_CAIS_var_sn": (tod.CAIS_VAR, jod.CAIS_VAR)}
SIGMA = {"gmm": 3.0, "many_gmm": 8.0}
# tests/test_pallas_kl.py:72-77 in this slice, and the gmm CAIS recipes' mode.
SWEEP_CASES = [("many_gmm", "MCD_ULA_sn"), ("gmm", "MCD_ULA"), ("gmm", "MCD_CAIS_sn")]


def make_case(target_name, mode, n=N, k=K, eps=0.1, eps_schedule="", grad_clipping=True):
    """One problem in both packages (tests/test_pallas_kl.make_case): eps, vd
    and the beta knots trainable, non-uniform knots, an off-centre
    variational mean; a net with factor_sn 0.3 and a random head where the
    mode has one."""
    jt = cmcd_tpu.load_target(target_name)
    kw = dict(mode=mode, dim=2, nbridges=k, emb_dim=EMB, grad_clipping=grad_clipping,
              eps_schedule=eps_schedule)
    jsetup = jb.CMCDSetup(**kw)
    trainable = jb.default_trainable(mode, train_eps=True, train_vi=True)
    params, jctx = jb.initialize(jsetup, jt.log_prob, eps=eps, init_sigma=SIGMA[target_name],
                                 trainable=trainable)
    if "sn" in params["train"]:
        sn = params["train"]["sn"]
        sn["factor_sn"] = jnp.asarray(0.3)
        sn["head"]["w"] = 0.05 * jax.random.normal(jax.random.PRNGKey(9), sn["head"]["w"].shape)
    params["train"]["mgridref_y"] = jax.random.uniform(
        jax.random.PRNGKey(4), params["train"]["mgridref_y"].shape, minval=0.5, maxval=1.5)
    params["train"]["vd"]["mean"] = jnp.array([0.5, -0.5])
    rng = np.random.default_rng(2)
    base = rng.standard_normal((n, 2)).astype(np.float32)
    noise = rng.standard_normal((k, n, 2)).astype(np.float32)
    target = load_target(target_name, device="cpu")
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
    """(z0, the port rollout's arguments after w0, its keywords) from the
    port's merged parameters."""
    p = tb.merged_params(case["params"])
    betas = betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"]).detach()
    z0 = (p["vd"]["mean"] + torch.exp(p["vd"]["logdiag"]) * case["draws"]["base_normals"]).detach()
    args = (betas, p["eps"].detach(), p["vd"]["mean"].detach(), p["vd"]["logdiag"].detach(),
            score_for_target(case["target"]), SPECS[case["mode"]][0])
    s = case["setup"]
    kw = dict(dim=2, nbridges=case["k"], sn=p.get("sn"), eps_schedule=s.eps_schedule,
              grad_clipping=s.grad_clipping)
    return z0, args, kw


def jax_rollout(case):
    """The JAX scan integrator as a function of (eps, betas, vd, sn, z0):
    (z_K, w_delta) under the injected noise."""
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


@pytest.mark.parametrize("target_name", ["many_gmm", "gmm"])
@pytest.mark.parametrize("mode", ["MCD_ULA", "MCD_ULA_sn"])
def test_plain_rollout_matches_jax_scan(target_name, mode):
    """ULA never clips, under grad_clipping too; ULA_sn's net serves the
    backward mean at (z_{i+1}, i) only."""
    case = make_case(target_name, mode)
    run, theta, z0_j = jax_rollout(case)
    z_j, w_j = run(theta, z0_j)
    z0, args, kw = port_args(case)
    before = evolve_overdamped_fused.launches
    z, w = evolve_overdamped_fused(z0, torch.zeros(N), *args, noise=case["draws"]["noise"], **kw)
    assert evolve_overdamped_fused.launches == before  # no kernel on a CPU tensor
    # 1e-5 abs, and 1e-6 of |z| where |z| is large (many_gmm's chains reach
    # |z| ~ 20, where one float32 step is 1.9e-6).
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=1e-4, rtol=0)


def _port_grads_in_jax_layout(case, g):
    """The sweep's gradient dict with the net's leaves in the JAX layout."""
    out = {k: g[k].numpy() for k in ("eps", "betas", "vd_mean", "vd_logdiag")}
    sn = tb.merged_params(case["params"]).get("sn")
    if sn is not None:
        for name, p in sn.named_parameters():
            p.grad = g["sn"][name]
        out["sn"] = grads_to_numpy(sn)
    return out


@pytest.mark.parametrize("target_name,mode",
                         SWEEP_CASES + [("gmm", "MCD_ULA_sn"), ("many_gmm", "MCD_ULA")])
def test_sweep_plain_matches_jax_grad_of_the_scan(target_name, mode):
    """sum_n [c_n w_delta_n + g_n . z_K] differentiated in theta and z0: the
    plain sweep on the plain rollout's path against jax.grad through the scan."""
    case = make_case(target_name, mode)
    run, theta, z0_j = jax_rollout(case)
    cot = case["rng"].standard_normal(N).astype(np.float32)
    g_zf = case["rng"].standard_normal((N, 2)).astype(np.float32)

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


def test_sweep_plain_in_float64_agrees_with_float32():
    """The arbiter of the card's compare, for the net-free and the
    backward-net forms."""
    for target_name, mode in (("gmm", "MCD_ULA"), ("many_gmm", "MCD_ULA_sn")):
        case = make_case(target_name, mode)
        z0, args, kw = port_args(case)
        _, _, traj, noise = evolve_overdamped_fused_plain(
            z0, torch.zeros(N), *args, noise=case["draws"]["noise"], return_trajectory=True,
            return_noise=True, **kw)
        cot, g_zf = torch.ones(N), torch.zeros(N, 2)
        g32, z32 = evolve_kl_bwd_plain(traj, noise, cot, g_zf, *args, **kw)
        g64, z64 = evolve_kl_bwd_plain(traj.double(), noise.double(), cot, g_zf, *args, **kw)
        assert z64.dtype == torch.float64
        flat = lambda g: {**{k: v for k, v in g.items() if k != "sn"}, **g["sn"]}
        for name, want in {**flat(g64), "z0": z64}.items():
            got = {**flat(g32), "z0": z32}[name]
            assert float((got.double() - want).norm()) <= 1e-4 * float(want.norm()) + 1e-5, name


def torch_value_and_grad(case, loss_fn):
    """loss_fn(params, n, ctx, setup, **draws) under autograd: the loss and
    the gradient tree of the trainable leaves in the JAX layout (modes
    without a net too)."""
    train = case["params"]["train"]
    leaves = [train[k] for k in ("eps", "eta", "gamma", "mgridref_y")] + [*train["vd"].values()]
    if "sn" in train:
        leaves += [*train["sn"].parameters()]
    for leaf in leaves:
        leaf.requires_grad_(True)
        leaf.grad = None
    loss, _ = loss_fn(case["params"], case["n"], case["ctx"], case["setup"], **case["draws"])
    loss.backward()
    return float(loss.detach()), grads_to_numpy(train)


def jax_scan_loss(case):
    """The JAX scan KL loss of tests/test_pallas_kl.py under the case's
    base normals and noise, as a function of the trainable tree."""
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


@pytest.mark.parametrize("target_name,mode", SWEEP_CASES)
def test_kl_bound_fused_with_train_vi_matches_jax_scan_and_pallas(target_name, mode):
    """The whole KL loss with the variational draw trained: loss and every
    leaf, vd's included, against JAX's scan loss and its fused Pallas loss
    (interpret mode; its draw is the same base normals, made from the key)."""
    case = make_case(target_name, mode)
    fused_loss = lambda p, n_, c, s, **d: kl_bound_fused(p, n_, c, s, case["target"], **d)
    got_l, got_g = torch_value_and_grad(case, fused_loss)
    want_l, want_g = jax.value_and_grad(jax_scan_loss(case))(case["jparams"]["train"])
    np.testing.assert_allclose(got_l, float(want_l), rtol=1e-4)
    assert_grads_close(got_g, want_g, rel=2e-4)
    assert np.linalg.norm(got_g["vd"]["mean"]) > 1e-3  # train_vi: a live vd gradient

    # kl_bound_pallas draws z0 from its key: hand the port the same normals.
    z_key = jax.random.split(case["key"])[0]
    case["draws"]["base_normals"] = torch.from_numpy(
        np.array(jax.random.normal(z_key, (N, 2)), np.float32))

    def pallas_loss(train):
        return kl_bound_pallas({"train": train, "notrain": case["jparams"]["notrain"]},
                               case["key"], N, case["jctx"], case["jsetup"], case["jt"],
                               block=128, noise=case["jnoise"], interpret=True)[0]

    got_l, got_g = torch_value_and_grad(case, fused_loss)
    want_l, want_g = jax.value_and_grad(pallas_loss)(case["jparams"]["train"])
    np.testing.assert_allclose(got_l, float(want_l), rtol=1e-4)
    assert_grads_close(got_g, want_g, rel=2e-4)


STEPS = 5


def test_five_gmm_ula_steps_match_the_jax_trainer():
    """The gmm_ula recipe's flags (MCD_ULA, init_eps 0.05, init_sigma 3, lr
    0.01, eps, vd and the betas trained, no clipping) at K=4 in both
    packages' trainers under the same draws, the fused KL loss on the
    port's side: losses and every parameter after five Adam steps."""
    case = make_case("gmm", "MCD_ULA", n=64, k=4, eps=0.05, grad_clipping=False)
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
        z, wd, _ = jod.evolve_overdamped(step_key, z, betas, p, ctx, jod.ULA, noise=noise_all[t])
        neg = -(w + wd + ctx.target_log_prob(z))
        return jnp.mean(neg), (neg, z)

    trainable = case["trainable"]
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
    # Adam divides each step by the gradient's running scale, so float32
    # rounding of the gradients (~1e-4 of a leaf here) carries into the
    # parameters: after five steps JAX's eps lies 8.7e-5 (relative) from the
    # same run in float64, the port's 2.0e-5. The limit is 2e-4 per leaf.
    for g, w in zip(got_l, want_l):
        assert np.linalg.norm(g - w) <= 2e-4 * np.linalg.norm(w) + 1e-7
    assert float(got.params["train"]["eps"]) != 0.05  # eps trains
    assert not np.allclose(params_to_numpy(got.params["train"])["vd"]["mean"], [0.5, -0.5])


def test_gates_words_and_the_dropped_schedule():
    """ULA, ULA_sn, CAIS and DNF on both targets take the fused paths; ULA
    has no net to ask for; its setup drops an eps schedule, and the rollout
    then runs the constant one."""
    assert OD_KL_FUSED_MODES == {"MCD_CAIS_sn", "MCD_ULA_sn", "MCD_ULA", "MCD_DNF"}
    for name in ("many_gmm", "gmm"):
        target = load_target(name, device="cpu")
        for mode in OD_KL_FUSED_MODES:
            setup = tb.CMCDSetup(mode=mode, dim=2, nbridges=256, emb_dim=130)
            assert supports_fused(setup, target) and supports_fused_train(setup, target)
            loss, words = fused_training_path(setup, 2000)
            assert loss is kl_bound_fused and words == "kl_bound_fused, KL reverse sweep"
        # No net: nn_arch and the width do not matter.
        wide = tb.CMCDSetup(mode="MCD_ULA", dim=2, nbridges=8, emb_dim=500, nn_arch="other")
        assert fused.net_width(wide) == 0 and supports_fused_train(wide, target)
        # With a net they do: in_dim 302 fits neither block.
        wide_sn = tb.CMCDSetup(mode="MCD_ULA_sn", dim=2, nbridges=8, emb_dim=300)
        assert not supports_fused(wide_sn, target) and not supports_fused_train(wide_sn, target)
    case = make_case("gmm", "MCD_ULA")
    dropped = tb.CMCDSetup(mode="MCD_ULA", dim=2, nbridges=K, eps_schedule="cos_sq")
    assert dropped.eps_schedule == ""
    outs = [compute_elbos_fused(case["params"], N, s, case["target"], **case["draws"])[0]
            for s in (dropped, tb.CMCDSetup(mode="MCD_ULA", dim=2, nbridges=K))]
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("bad", ["spec", "score", "dim"])
def test_sweep_refuses_what_no_kernel_takes(bad):
    """VarGrad's spec stops the state gradient; a plain callable is no
    kernel score; gmm's template is instantiated at dim 2, not 10."""
    case = make_case("gmm", "MCD_ULA")
    z0, (betas, eps, mean, logdiag, score, spec), kw = port_args(case)
    traj, noise = torch.zeros(K + 1, N, 2), torch.zeros(K, N, 2)
    if bad == "spec":
        spec = tod.CAIS_VAR
    elif bad == "score":
        score = lambda z: -z
    elif bad == "dim":
        kw["dim"] = 10
    with pytest.raises((NotImplementedError, ValueError)):
        evolve_kl_bwd(traj, noise, torch.zeros(N), torch.zeros(N, 2), betas, eps, mean,
                      logdiag, score, spec, **kw)


GMM_ULA = ("--config.model gmm --config.boundmode MCD_ULA --config.N 300 --config.nbridges 8 "
           "--config.init_eps 0.05 --config.init_sigma 3 --config.lr 0.01 --config.iters 100 "
           "--config.n_samples 128 --config.n_input_dist_seeds 4 --noconfig.pretrain_mfvi "
           "--config.log.every 1 --config.steps_per_call 10").split()

# Every kernel wrapper the overdamped KL path must not reach, by the module
# that would reach it.
OTHER_WRAPPERS = {
    fused.uha: ["evolve_uha_fused"],
    fused.underdamped: ["evolve_underdamped_fused"],
    fused.overdamped_wide: ["evolve_overdamped_wide"],
    fused_train: ["evolve_underdamped_fused", "evolve_underdamped_fused_plain",
                  "evolve_vargrad_bwd_replay", "evolve_vargrad_bwd_replay_plain",
                  "evolve_vargrad_bwd_reroll", "evolve_vargrad_bwd_reroll_plain",
                  "evolve_kl_bwd_underdamped", "evolve_kl_bwd_underdamped_plain",
                  "evolve_kl_bwd_uha", "evolve_kl_bwd_uha_plain",
                  "evolve_overdamped_wide", "evolve_overdamped_wide_plain",
                  "evolve_kl_split", "evolve_kl_split_plain"],
}


def test_cli_trains_gmm_ula_on_cpu_through_the_overdamped_wrappers(tmp_path, monkeypatch,
                                                                    capsys):
    """The gmm_ula recipe's flags through the CLI on the CPU (100 steps):
    the fused KL loss (plain rollout and sweep), the fused evaluation; no
    other kernel's wrapper is called, the loss falls; tools/log_summary reads
    the run's JSONL log back."""
    def refuse(name):
        def fn(*a, **k):
            raise AssertionError(f"the ULA path called {name}")
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

    rollout = spy("rollout", overdamped.evolve_overdamped_fused)
    monkeypatch.setattr(overdamped, "evolve_overdamped_fused", rollout)      # evaluation
    monkeypatch.setattr(fused_train, "evolve_overdamped_fused", rollout)     # training
    monkeypatch.setattr(fused_train, "evolve_kl_bwd", spy("sweep", kl.evolve_kl_bwd))
    log = tmp_path / "gmm_ula.jsonl"
    out = run_experiment(parse_flags(GMM_ULA + ["--config.log.jsonl", str(log)]), device="cpu")
    printed = capsys.readouterr().out
    assert "kl_bound_fused, KL reverse sweep" in printed
    assert calls == {"rollout": 100 + 4, "sweep": 100}
    result = out["train"]
    assert result.steps_done == 100 and not result.diverged
    losses = result.losses.double()
    assert torch.isfinite(losses).all() and losses[-20:].mean() < losses[:20].mean()
    assert np.isfinite(out["final_ln_Z"]) and out["neg_elbos"].shape == (4, 128)
    summary = log_summary.summarise(str(log))
    assert summary["final_elbo"] == out["final_elbo"] and summary["last_step"] == 99
    assert summary["median_step_ms"] > 0 and summary["final_ln_Z_std"] > 0
