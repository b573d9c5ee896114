"""The port's underdamped KL (backprop-through-time) gradient against the JAX
package, on the CPU, under the same base normals and injected noise, for
the approximate-refresh modes (MCD_U_a-lp, -sna, -sn; LDVI is the last).

Layers, each held to the next: the eager kl_bound under torch.autograd (the
oracle) against jax.grad of the scan loss; the reverse sweep's plain version
against the Pallas kernel evolve_kl_bwd_underdamped in interpret mode on the
same stores and cotangents; the custom VJP kl_bound_fused (plain versions on
a CPU tensor) against jax.grad of the scan loss and, for LDVI, against
kl_bound_pallas; five optimizer steps of `train` against the JAX trainer;
the CLI on the CPU.

Tolerances as tests/test_pallas_kl.py:233-248: loss rtol 1e-4, gradient
|g_t - g_j| < 2e-4 |g_j| + 1e-4 over the flattened tree and per leaf (eps,
gamma and vd trainable, so a wrong small leaf cannot hide behind the net).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmcd_tpu import bounds as jb
from cmcd_tpu.distributions import diag_gaussian_log_prob as j_log_prob
from cmcd_tpu.integrators import underdamped as jud
from cmcd_tpu.ops.fused_train import kl_bound_pallas
from cmcd_tpu.ops.pallas_kl import evolve_kl_bwd_underdamped as j_sweep
from cmcd_tpu.ops.pallas_underdamped import evolve_underdamped_pallas
from cmcd_tpu.schedules import betas_from_grid as j_betas_from_grid
from cmcd_tpu.train import trainer as jtrainer
from cmcd_tpu_torch import bounds as tb
from cmcd_tpu_torch.main import parse_flags, run_experiment
from cmcd_tpu_torch.ops.fused_train import (
    KL_FUSED_MODES,
    UD_KL_FUSED_MODES,
    fused_training_path,
    kl_bound_fused,
    supports_fused_train,
)
from cmcd_tpu_torch.ops.kl_underdamped import (
    evolve_kl_bwd_underdamped,
    evolve_kl_bwd_underdamped_plain,
)
from cmcd_tpu_torch.ops.underdamped import evolve_underdamped_fused
from cmcd_tpu_torch.targets import load_target
from cmcd_tpu_torch.train import train
from cmcd_tpu_torch.utils.convert import grads_to_numpy, params_to_numpy
from test_torch_underdamped import (
    from_t,
    jax_rollout_args,
    make_ud_case,
    port_rollout_args,
)
from test_torch_vargrad import assert_grads_close

torch.set_num_threads(1)

K, N = 4, 96
APPROX = ["MCD_U_a-lp", "MCD_U_a-lp-sna", "MCD_U_a-lp-sn"]


def scan_neg_elbos(case):
    """The negative ELBOs of the JAX scan stepper (tests/test_pallas_kl.py::
    scan_kl_loss_fn_ud) as a function of the trainable tree."""
    params, ctx, key, n = case["jparams"], case["jctx"], case["key"], case["n"]

    def neg_elbos(train):
        p = jb.merged_params({"train": train, "notrain": params["notrain"]})
        z_key, evolve_key = jax.random.split(key)
        z = p["vd"]["mean"] + jnp.exp(p["vd"]["logdiag"]) * jax.random.normal(z_key, (n, 2))
        w = -j_log_prob(p["vd"], z)
        betas = j_betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])
        z, wd, _ = jud.evolve_underdamped(evolve_key, z, betas, p, ctx, case["jspec"],
                                          noise=case["jnoise"])
        return -(w + wd + ctx.target_log_prob(z))

    return neg_elbos


def scan_loss(case):
    neg_elbos = scan_neg_elbos(case)
    return lambda train: jnp.mean(neg_elbos(train))


def torch_value_and_grad(case, loss_fn):
    """loss_fn(params, n, ctx, setup, **draws) under autograd: the loss and
    the gradient tree in the JAX layout (zeros for an unused leaf)."""
    train = case["params"]["train"]
    leaves = [train[k] for k in ("eps", "eta", "gamma", "mgridref_y")]
    leaves += [*train["vd"].values()]
    if "sn" in train:
        leaves += [*train["sn"].parameters()]
    for leaf in leaves:
        leaf.requires_grad_(True)
        leaf.grad = None
    loss, _ = loss_fn(case["params"], case["n"], case["ctx"], case["setup"], **case["draws"])
    loss.backward()
    return float(loss.detach()), grads_to_numpy(train)


def fused(case):
    return lambda p, n, c, s, **d: kl_bound_fused(p, n, c, s, case["target"], **d)


@pytest.mark.parametrize("mode", APPROX)
def test_eager_kl_bound_grad_matches_jax_scan(mode):
    case = make_ud_case(mode)
    want_l, want_g = jax.value_and_grad(scan_loss(case))(case["jparams"]["train"])
    got_l, got_g = torch_value_and_grad(case, tb.kl_bound)
    np.testing.assert_allclose(got_l, float(want_l), rtol=1e-4)
    assert_grads_close(got_g, want_g, rel=2e-4)


def _to_jax_layout(case, g):
    """A port gradient dict of the sweep as the JAX kernel's."""
    out = {k: g[k].numpy() for k in ("eps", "gamma", "eta", "betas", "vd_mean", "vd_logdiag")}
    if "sn" in g:
        sn = case["params"]["train"]["sn"]
        for name, p in sn.named_parameters():
            p.grad = g["sn"][name]
        out["sn"] = grads_to_numpy(sn)
    return out


@pytest.mark.parametrize("mode", APPROX)
def test_sweep_plain_matches_jax_sweep_kernel(mode):
    case = make_ud_case(mode)
    z0_j, j_args, j_kw = jax_rollout_args(case)
    _, _, zt, rt, nt = evolve_underdamped_pallas(
        z0_j, *j_args, **j_kw, noise=case["jnoise"], block=128, interpret=True,
        return_state_t=True)
    cot = case["rng"].standard_normal(N).astype(np.float32)
    g_zfinal = case["rng"].standard_normal((N, 2)).astype(np.float32)
    want, want_z0 = j_sweep(zt, rt, nt, jnp.asarray(cot), jnp.asarray(g_zfinal), *j_args,
                            n_chains=N, block=128, interpret=True, **j_kw)
    _, args, kw = port_rollout_args(case)
    stack = lambda x_t: torch.from_numpy(np.ascontiguousarray(from_t(x_t, N)))
    before = evolve_kl_bwd_underdamped.launches
    got, got_z0 = evolve_kl_bwd_underdamped(stack(zt), stack(rt), stack(nt),
                                            torch.from_numpy(cot), torch.from_numpy(g_zfinal),
                                            *args, **kw)
    assert evolve_kl_bwd_underdamped.launches == before  # no kernel on a CPU tensor
    assert float(got["eta"]) == 0.0
    assert_grads_close(_to_jax_layout(case, got), jax.device_get(want), rel=2e-4)
    want_z0 = np.asarray(want_z0)
    assert np.linalg.norm(got_z0.numpy() - want_z0) < 2e-4 * np.linalg.norm(want_z0) + 1e-4
    assert np.linalg.norm(want_z0) > 1.0


def test_sweep_plain_in_float64_agrees_with_float32():
    """The arbiter of two float32 summation orders: the same sweep in
    float64 on the same inputs."""
    case = make_ud_case("MCD_U_a-lp-sn")
    z0, args, kw = port_rollout_args(case)
    _, _, zt, rt, dr = evolve_underdamped_fused(z0, torch.zeros(N), *args, **kw,
                                                noise=case["draws"]["noise"], return_state=True)
    cot, g_zf = torch.ones(N), torch.zeros(N, 2)
    g32, z32 = evolve_kl_bwd_underdamped_plain(zt, rt, dr, cot, g_zf, *args, **kw)
    g64, z64 = evolve_kl_bwd_underdamped_plain(zt.double(), rt.double(), dr.double(), cot, g_zf,
                                               *args, **kw)
    assert z64.dtype == torch.float64 and g64["sn"]["emb"].dtype == torch.float64
    flat = lambda g, z: {**{k: v for k, v in g.items() if k != "sn"}, **g["sn"], "z0": z}
    got_all, want_all = flat(g32, z32), flat(g64, z64)
    for name, want in want_all.items():
        err = float((got_all[name].double() - want).norm())
        assert err <= 1e-4 * float(want.norm()) + 1e-5, name


@pytest.mark.parametrize("mode", APPROX)
def test_kl_bound_fused_matches_jax_grad_of_scan(mode):
    case = make_ud_case(mode)
    assert supports_fused_train(case["setup"], case["target"])
    want_l, want_g = jax.value_and_grad(scan_loss(case))(case["jparams"]["train"])
    got_l, got_g = torch_value_and_grad(case, fused(case))
    np.testing.assert_allclose(got_l, float(want_l), rtol=1e-4)
    assert_grads_close(got_g, want_g, rel=2e-4)


def test_kl_bound_fused_ldvi_matches_kl_bound_pallas():
    case = make_ud_case("MCD_U_a-lp-sn")

    def pallas_loss(train):
        return kl_bound_pallas(
            {"train": train, "notrain": case["jparams"]["notrain"]}, case["key"], N,
            case["jctx"], case["jsetup"], case["jt"], block=128, noise=case["jnoise"],
            interpret=True)[0]

    want_l, want_g = jax.value_and_grad(pallas_loss)(case["jparams"]["train"])
    got_l, got_g = torch_value_and_grad(case, fused(case))
    np.testing.assert_allclose(got_l, float(want_l), rtol=1e-4)
    assert_grads_close(got_g, want_g, rel=2e-4)


def test_kl_modes_and_training_path_cover_the_approximate_refresh():
    assert UD_KL_FUSED_MODES == set(APPROX) and UD_KL_FUSED_MODES <= KL_FUSED_MODES
    target = load_target("many_gmm", device="cpu")
    for mode in APPROX:
        setup = tb.CMCDSetup(mode=mode, dim=2, nbridges=256, emb_dim=130)
        assert supports_fused_train(setup, target)
        loss, words = fused_training_path(setup, 2000)
        assert loss is kl_bound_fused and "underdamped" in words
    for mode in ("MCD_U_e-lp", "MCD_U_ea-lp-sn", "MCD_CAIS_UHA_sn"):
        setup = tb.CMCDSetup(mode=mode, dim=2, nbridges=8, emb_dim=16)
        assert not supports_fused_train(setup, target)
        with pytest.raises(NotImplementedError):
            kl_bound_fused({}, 8, None, setup, target)


STEPS = 5


def test_five_ldvi_steps_match_the_jax_trainer():
    """train in both packages from the same parameters under the same draws,
    the fused LDVI loss on the port's side: losses and every parameter after
    five Adam steps (eta's gradient is zero on both sides, so eta stays)."""
    case = make_ud_case("MCD_U_a-lp-sn", n=64)
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
        z, wd, _ = jud.evolve_underdamped(step_key, z, betas, p, ctx, case["jspec"],
                                          noise=noise_all[t])
        neg = -(w + wd + ctx.target_log_prob(z))
        return jnp.mean(neg), (neg, z)

    trainable = jb.default_trainable("MCD_U_a-lp-sn", train_eps=False, train_vi=False)
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
    start = jax.tree_util.tree_leaves(jax.device_get(case["jparams"]["train"]))
    moved = 0.0
    for g, w, s in zip(got_l, want_l, start):
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w) + 1e-7
        moved += float(np.linalg.norm(np.asarray(w) - np.asarray(s)))
    assert moved > 0.1
    eta = float(got.params["train"]["eta"])
    assert eta == float(case["jparams"]["train"]["eta"])


LDVI_TINY = ("--config.model many_gmm --config.boundmode MCD_U_a-lp-sn --config.nbridges 4 "
             "--config.emb_dim 8 --config.N 64 --config.n_samples 64 "
             "--config.n_input_dist_seeds 2 --config.init_eps 0.05 --config.init_gamma 5.0 "
             "--config.init_sigma 15 --config.grad_clipping True --config.train_eps False "
             "--config.train_vi False --config.lr 0.005 --config.iters 40 "
             "--config.log.every 1 --noconfig.pretrain_mfvi").split()


def test_run_experiment_trains_ldvi_on_cpu(capsys):
    """MCD_U_a-lp-sn through the CLI's phases on the CPU: the fused KL loss
    (plain versions of the underdamped rollout and sweep) and the fused
    evaluation."""
    out = run_experiment(parse_flags(LDVI_TINY), device="cpu")
    printed = capsys.readouterr().out
    assert "kl_bound_fused, underdamped rollout and KL reverse sweep" in printed
    assert "Using the fused evaluation path on cpu" in printed
    result = out["train"]
    assert result.steps_done == 40 and not result.diverged
    losses = result.losses.double()
    assert len(losses) == 40 and torch.isfinite(losses).all()
    assert np.isfinite(out["final_ln_Z"]) and np.isfinite(out["final_elbo"])
    assert out["neg_elbos"].shape == (2, 64)
