"""The port's underdamped KL (backprop-through-time) gradient against the JAX
package, on the CPU, under the same base normals and injected noise, for all
seven underdamped modes (the approximate refresh MCD_U_a-lp, -sna, -sn, LDVI
the last; the exact refresh MCD_U_e-lp, -sna; MCD_U_ea-lp-sn;
MCD_CAIS_UHA_sn) on many_gmm, the 3-mode gmm and Neal's funnel (dim 10;
CAIS_UHA's with its target score clip engaged).

Layers, each held to the next: the eager kl_bound under torch.autograd (the
oracle) against jax.grad of the scan loss; the reverse sweep's plain version
against the Pallas kernel evolve_kl_bwd_underdamped in interpret mode on the
same stores and cotangents, and in float64 against float64 autograd through
the eager stepper (exact_fwd's log-normalisers, CAIS_UHA's per-point step
size, forward net and clip); the custom VJP kl_bound_fused (plain versions
on a CPU tensor) against jax.grad of the scan loss and, for LDVI, against
kl_bound_pallas; five optimizer steps of `train` against the JAX trainer
(LDVI on many_gmm, CAIS_UHA on the funnel); the CLI on the CPU.

Tolerances as tests/test_pallas_kl.py:233-248: loss rtol 1e-4, gradient
|g_t - g_j| < 2e-4 |g_j| + 1e-4 over the flattened tree and per leaf (eps,
gamma, eta and vd trainable, so a wrong small leaf cannot hide behind the
net); the float64 pair 1e-9 of each leaf's norm.
"""

import copy

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
from cmcd_tpu_torch.integrators import UNDERDAMPED
from cmcd_tpu_torch.integrators import underdamped as tud
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
from cmcd_tpu_torch.ops.target_grads import score_for_target
from cmcd_tpu_torch.ops.underdamped import (
    UD_TARGETS,
    evolve_underdamped_fused,
    evolve_underdamped_fused_plain,
)
from cmcd_tpu_torch.schedules import betas_from_grid
from cmcd_tpu_torch.targets import Target, load_target
from cmcd_tpu_torch.train import train
from cmcd_tpu_torch.utils.convert import grads_to_numpy, params_to_numpy
from test_torch_underdamped import (
    TARGETS,
    from_t,
    jax_rollout_args,
    make_ud_case,
    port_rollout_args,
)
from test_torch_vargrad import assert_grads_close

torch.set_num_threads(1)

K, N = 4, 96
APPROX = ["MCD_U_a-lp", "MCD_U_a-lp-sna", "MCD_U_a-lp-sn"]
ALL = list(UNDERDAMPED)


def clipped_elements(case, ztraj):
    """Target score elements past CAIS_UHA's clip (1e2) at the stored
    positions."""
    score = score_for_target(case["target"])
    return int((score(ztraj.reshape(-1, case["dim"])).abs() > tud.CAIS_UHA_CLIP).sum())


def scan_neg_elbos(case):
    """The negative ELBOs of the JAX scan stepper (tests/test_pallas_kl.py::
    scan_kl_loss_fn_ud) as a function of the trainable tree."""
    params, ctx, key, n = case["jparams"], case["jctx"], case["key"], case["n"]

    def neg_elbos(train):
        p = jb.merged_params({"train": train, "notrain": params["notrain"]})
        z_key, evolve_key = jax.random.split(key)
        z = p["vd"]["mean"] + jnp.exp(p["vd"]["logdiag"]) * jax.random.normal(
            z_key, (n, case["dim"]))
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


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("mode", ALL)
def test_eager_kl_bound_grad_matches_jax_scan(mode, target):
    case = make_ud_case(mode, target=target)
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


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("mode", ALL)
def test_sweep_plain_matches_jax_sweep_kernel(mode, target):
    case = make_ud_case(mode, target=target)
    dim = case["dim"]
    z0_j, j_args, j_kw = jax_rollout_args(case)
    _, _, zt, rt, nt = evolve_underdamped_pallas(
        z0_j, *j_args, **j_kw, noise=case["jnoise"], block=128, interpret=True,
        return_state_t=True)
    cot = case["rng"].standard_normal(N).astype(np.float32)
    g_zfinal = case["rng"].standard_normal((N, dim)).astype(np.float32)
    want, want_z0 = j_sweep(zt, rt, nt, jnp.asarray(cot), jnp.asarray(g_zfinal), *j_args,
                            n_chains=N, block=128, interpret=True, **j_kw)
    _, args, kw = port_rollout_args(case)
    stack = lambda x_t: torch.from_numpy(np.ascontiguousarray(from_t(x_t, N, dim)))
    before = evolve_kl_bwd_underdamped.launches
    got, got_z0 = evolve_kl_bwd_underdamped(stack(zt), stack(rt), stack(nt),
                                            torch.from_numpy(cot), torch.from_numpy(g_zfinal),
                                            *args, **kw)
    assert evolve_kl_bwd_underdamped.launches == before  # no kernel on a CPU tensor
    # The exact refresh reads eta and never gamma, the others gamma and never eta.
    unused = "gamma" if case["spec"].refresh == "exact" else "eta"
    assert float(got[unused]) == 0.0 and float(want[unused]) == 0.0
    if (mode, target) == ("MCD_CAIS_UHA_sn", "funnel"):  # the clip and its VJP are held
        assert clipped_elements(case, stack(zt)) > 100
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


@pytest.mark.parametrize("mode", ["MCD_U_ea-lp-sn", "MCD_CAIS_UHA_sn", "MCD_U_e-lp-sna"])
def test_sweep_plain_in_float64_matches_autograd_through_the_eager_stepper(mode):
    """The hand-walked sweep where a written-out VJP goes wrong silently:
    exact_fwd's log-normalisers D (log s_f - log s_b) with their own eps and
    gamma gradient, CAIS_UHA's per-point step size eps0 cos^2, its forward
    net feeding the backward net's input and its clipped score (engaged
    here), the exact refresh's eta. Both sides in float64 on the funnel: the
    plain sweep on the plain rollout's stores against torch.autograd of
    sum_n [c_n w_n + g_n . z_K] through integrators/underdamped.py, every
    leaf (eps, gamma, eta, betas, vd, z0, the net) within 1e-9 of its norm."""
    case = make_ud_case(mode, target="funnel", n=64)
    spec, dim, k, n = case["spec"], case["dim"], case["k"], case["n"]
    p = tb.merged_params(case["params"])
    d64 = lambda t: t.detach().double().clone().requires_grad_(True)
    eps, gamma, eta = d64(p["eps"]), d64(p["gamma"]), d64(p["eta"])
    betas = d64(betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"]))
    mean, logdiag = d64(p["vd"]["mean"]), d64(p["vd"]["logdiag"])
    z0 = d64(p["vd"]["mean"] + torch.exp(p["vd"]["logdiag"]) * case["draws"]["base_normals"])
    sn = copy.deepcopy(p["sn"]).double() if "sn" in p else None
    noise = case["draws"]["noise"].double()
    rng = np.random.default_rng(5)
    cot = torch.from_numpy(rng.standard_normal(n))
    g_zf = torch.from_numpy(rng.standard_normal((n, dim)))
    params = {"eps": eps, "gamma": gamma, "eta": eta, "vd": {"mean": mean, "logdiag": logdiag}}
    weights = []
    if sn is not None:
        params["sn"], weights = sn, list(sn.parameters())
    z_k, w, _ = tud.evolve_underdamped(z0, betas, params, case["ctx"], spec, noise=noise)
    leaves = [eps, gamma, eta, betas, mean, logdiag, z0, *weights]
    want = torch.autograd.grad(torch.sum(cot * w) + torch.sum(g_zf * z_k), leaves,
                               allow_unused=True)
    score = score_for_target(case["target"])
    _, _, zt, rt, dr = evolve_underdamped_fused_plain(
        z0.detach(), torch.zeros(n, dtype=torch.float64), betas.detach(), eps.detach(),
        gamma.detach(), eta.detach(), mean.detach(), logdiag.detach(), score, spec, dim=dim,
        nbridges=k, sn=sn, noise=noise, return_state=True)
    assert zt.dtype == torch.float64
    if spec.cais:
        assert clipped_elements(case, zt) > 100
    g, g_z0 = evolve_kl_bwd_underdamped_plain(
        zt, rt, dr, cot, g_zf, betas.detach(), eps.detach(), gamma.detach(), eta.detach(),
        mean.detach(), logdiag.detach(), score, spec, dim=dim, nbridges=k, sn=sn)
    got = [g["eps"], g["gamma"], g["eta"], g["betas"], g["vd_mean"], g["vd_logdiag"], g_z0]
    got += [g["sn"][name] for name, _ in sn.named_parameters()] if sn is not None else []
    names = ["eps", "gamma", "eta", "betas", "vd_mean", "vd_logdiag", "z0"]
    names += [name for name, _ in sn.named_parameters()] if sn is not None else []
    for name, a, b in zip(names, got, want):
        b = torch.zeros_like(a) if b is None else b
        assert a.dtype == torch.float64, name
        assert float((a - b).norm()) <= 1e-9 * float(b.norm()) + 1e-12, name
    unused = 2 if spec.refresh != "exact" else 1  # eta, or gamma under the exact refresh
    assert float(got[unused]) == 0.0 and float(got[3 - unused].norm()) > 1e-3


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("mode", ALL)
def test_kl_bound_fused_matches_jax_grad_of_scan(mode, target):
    case = make_ud_case(mode, target=target)
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
    """Every underdamped mode trains through the fused KL loss on each target
    of the kernels at its width (the approximate refresh, LDVI's full width,
    among them); what stays refused: MCD_DNF with a PIS net (DNF trains
    through the overdamped sweep's two-net form with the geffner nets only)
    and a target whose score no kernel inlines, before anything runs."""
    assert UD_KL_FUSED_MODES == set(ALL) and UD_KL_FUSED_MODES <= KL_FUSED_MODES
    assert set(UD_TARGETS) == set(TARGETS)
    for name, dim, nbridges, emb in (("many_gmm", 2, 256, 130), ("gmm", 2, 8, 20),
                                     ("funnel", 10, 32, 48)):
        target = load_target(name, device="cpu")
        for mode in ALL:
            setup = tb.CMCDSetup(mode=mode, dim=dim, nbridges=nbridges, emb_dim=emb)
            assert supports_fused_train(setup, target), (name, mode)
            loss, words = fused_training_path(setup, 2000)
            assert loss is kl_bound_fused and "underdamped" in words
    many_gmm = load_target("many_gmm", device="cpu")
    normal = Target("std_normal", 10, lambda z: -0.5 * torch.sum(z * z, -1))
    for setup, target in ((tb.CMCDSetup(mode="MCD_DNF", dim=2, nbridges=8, nn_arch="dds",
                                        fully_connected_units=(16, 16)), many_gmm),
                          (tb.CMCDSetup(mode="MCD_U_ea-lp-sn", dim=10, nbridges=8, emb_dim=16),
                           normal)):
        assert not supports_fused_train(setup, target)
        with pytest.raises(NotImplementedError):
            kl_bound_fused({}, 8, None, setup, target)


STEPS = 5


def _five_steps_against_the_jax_trainer(case, lr, trainable):
    """train in both packages from the same parameters under the same draws,
    the fused KL loss on the port's side: losses and every parameter after
    STEPS Adam steps. Returns the port's TrainResult."""
    n, k, dim = case["n"], case["k"], case["dim"]
    rng = np.random.default_rng(11)
    draws = [(rng.standard_normal((n, dim)).astype(np.float32),
              rng.standard_normal((k + 1, n, dim)).astype(np.float32)) for _ in range(STEPS)]
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

    want = jtrainer.train(case["jsetup"], case["jparams"], case["jctx"], lr=lr, iters=STEPS,
                          batch_size=n, key=jax.random.PRNGKey(0), trainable=trainable,
                          loss_fn=j_loss, log_every=1, steps_per_call=1)
    step = {"i": 0}

    def loss_fn(params, n_, ctx, setup, generator=None):
        base, noise = draws[step["i"]]
        step["i"] += 1
        return kl_bound_fused(params, n_, ctx, setup, case["target"],
                              base_normals=torch.from_numpy(base),
                              noise=torch.from_numpy(noise))

    got = train(case["setup"], case["params"], case["ctx"], lr=lr, iters=STEPS,
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
    return got


def test_five_ldvi_steps_match_the_jax_trainer():
    """LDVI on many_gmm (eta's gradient is zero on both sides, so eta stays)."""
    case = make_ud_case("MCD_U_a-lp-sn", n=64)
    trainable = jb.default_trainable("MCD_U_a-lp-sn", train_eps=False, train_vi=False)
    got = _five_steps_against_the_jax_trainer(case, 0.005, trainable)
    eta = float(got.params["train"]["eta"])
    assert eta == float(case["jparams"]["train"]["eta"])


def test_five_cais_uha_funnel_steps_match_the_jax_trainer():
    """MCD_CAIS_UHA_sn on the funnel with the gate's flags (train_vi on,
    train_eps off, FUNNEL_EPS_DICT[32]'s init_eps 0.1 and lr 0.005, gamma
    10), cut to K=8, N=64, emb 16; gamma moves, eta (unread) stays."""
    case = make_ud_case("MCD_CAIS_UHA_sn", n=64, k=8, eps=0.1, gamma=10.0, init_sigma=1.0,
                        target="funnel")
    trainable = jb.default_trainable("MCD_CAIS_UHA_sn", train_eps=False, train_vi=True)
    assert "eps" not in trainable and "vd" in trainable and "gamma" in trainable
    got = _five_steps_against_the_jax_trainer(case, 0.005, trainable)
    train_p = got.params["train"]
    assert float(train_p["eta"]) == float(case["jparams"]["train"]["eta"])
    assert float(train_p["gamma"]) != float(case["jparams"]["train"]["gamma"])


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


CAIS_UHA_TINY = ("--config.model funnel --config.boundmode MCD_CAIS_UHA_sn --config.nbridges 8 "
                 "--config.emb_dim 8 --config.N 64 --config.n_samples 64 "
                 "--config.n_input_dist_seeds 2 --config.init_sigma 1 --config.train_vi True "
                 "--config.train_eps False --config.iters 20 --config.log.every 1 "
                 "--noconfig.pretrain_mfvi").split()


def test_run_experiment_trains_cais_uha_on_the_funnel_on_cpu(capsys):
    """MCD_CAIS_UHA_sn on the funnel through the CLI's phases on the CPU
    (FUNNEL_EPS_DICT[8]: init_eps 0.1, lr 0.01): the fused KL loss (plain
    versions of the underdamped rollout and sweep) and the fused evaluation,
    at dim 10."""
    cfg = parse_flags(CAIS_UHA_TINY)
    out = run_experiment(cfg, device="cpu")
    printed = capsys.readouterr().out
    assert "kl_bound_fused, underdamped rollout and KL reverse sweep" in printed
    assert "Using the fused evaluation path on cpu" in printed
    assert (cfg.init_eps, cfg.lr) == (0.1, 0.01)
    result = out["train"]
    assert result.steps_done == 20 and not result.diverged
    assert torch.isfinite(result.losses).all()
    assert np.isfinite(out["final_ln_Z"]) and np.isfinite(out["final_elbo"])
    assert out["neg_elbos"].shape == (2, 64) and out["samples"].shape == (2 * 64, 10)
