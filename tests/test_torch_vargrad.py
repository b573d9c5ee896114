"""The port's VarGrad gradient against the JAX package, on the CPU, under
the same base normals and injected noise.

Four layers, each held to the next (and the re-rolling backward beside the
replay at each of them): the eager var_bound under torch.autograd
(the oracle) against jax.grad of the scan loss; the replay backward's plain
version against the Pallas kernel evolve_vargrad_bwd_replay in interpret
mode on the same trajectory and cotangent; the rollout's stored trajectory
against the Pallas kernel's; and the custom VJP var_bound_fused (plain
versions on a CPU tensor) against the oracle and var_bound_pallas.

Tolerances as tests/test_pallas_vargrad.py: loss rtol 1e-4, gradient
|g_t - g_j| < 1e-4 |g_j| + 1e-4 over the flattened tree, and the same per
leaf so that a wrong small leaf (eps, vd) cannot hide behind the net's norm.
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
from cmcd_tpu.ops.fused import _dim_pad
from cmcd_tpu.ops.fused_train import var_bound_pallas
from cmcd_tpu.ops.pallas_overdamped import evolve_overdamped_pallas, pack_geffner_t
from cmcd_tpu.ops.pallas_vargrad import evolve_vargrad_bwd_pallas as j_reroll
from cmcd_tpu.ops.pallas_vargrad import evolve_vargrad_bwd_replay as j_replay
from cmcd_tpu.ops.target_grads import grad_t_for_target
from cmcd_tpu.schedules import betas_from_grid as j_betas_from_grid
from cmcd_tpu_torch import bounds as tb
from cmcd_tpu_torch.integrators import overdamped as tod
from cmcd_tpu_torch.ops import fused_train
from cmcd_tpu_torch.ops.fused_train import supports_fused_train, var_bound_fused
from cmcd_tpu_torch.ops.overdamped import evolve_overdamped_fused
from cmcd_tpu_torch.ops.target_grads import make_many_gmm_score
from cmcd_tpu_torch.ops.vargrad import (
    evolve_vargrad_bwd_replay,
    evolve_vargrad_bwd_replay_plain,
    evolve_vargrad_bwd_reroll,
    evolve_vargrad_bwd_reroll_plain,
    kernel_fits,
)
from cmcd_tpu_torch.schedules import betas_from_grid
from cmcd_tpu_torch.train.trainer import tree_leaves
from cmcd_tpu_torch.targets import load_target
from cmcd_tpu_torch.utils.convert import grads_to_numpy, params_from_jax

torch.set_num_threads(1)

K, N, EMB = 6, 128, 16


def make_case(eps_schedule="", grad_clipping=True, n=N, k=K, mode="MCD_CAIS_var_sn",
              eps=0.2, init_sigma=15.0):
    """One problem in both packages: every leaf trainable, factor_sn 0.3 and
    a random head so the whole net VJP is live, non-uniform beta knots, an
    off-centre variational mean."""
    jt = cmcd_tpu.load_target("many_gmm")
    kw = dict(mode=mode, dim=2, nbridges=k, emb_dim=EMB,
              grad_clipping=grad_clipping, eps_schedule=eps_schedule)
    jsetup = jb.CMCDSetup(**kw)
    trainable = jb.default_trainable(jsetup.mode)
    params, jctx = jb.initialize(jsetup, jt.log_prob, eps=eps, init_sigma=init_sigma,
                                 trainable=trainable)
    sn = params["train"]["sn"]
    sn["factor_sn"] = jnp.asarray(0.3)
    sn["head"]["w"] = 0.05 * jax.random.normal(jax.random.PRNGKey(9), sn["head"]["w"].shape)
    params["train"]["mgridref_y"] = jax.random.uniform(
        jax.random.PRNGKey(4), params["train"]["mgridref_y"].shape, minval=0.5, maxval=1.5)
    params["train"]["vd"]["mean"] = jnp.array([0.5, -0.5])
    key = jax.random.PRNGKey(0)
    base = np.array(jax.random.normal(jax.random.split(key)[0], (n, 2)))
    rng = np.random.default_rng(2)
    noise = rng.standard_normal((k, n, 2)).astype(np.float32)
    target = load_target("many_gmm", device="cpu")
    tsetup = tb.CMCDSetup(**kw)
    _, tctx = tb.initialize(tsetup, target.log_prob, device="cpu")
    return {
        "jt": jt, "jsetup": jsetup, "jparams": params, "jctx": jctx, "key": key,
        "jnoise": jnp.asarray(noise), "n": n, "k": k, "rng": rng,
        "target": target, "setup": tsetup, "ctx": tctx,
        "params": params_from_jax(jax.device_get(params), device="cpu"),
        "draws": {"base_normals": torch.from_numpy(base), "noise": torch.from_numpy(noise)},
    }


def scan_neg_elbos(case, spec):
    """The negative ELBOs of the JAX scan integrator under `spec`, as a
    function of the trainable tree."""
    params, ctx, key, n = case["jparams"], case["jctx"], case["key"], case["n"]

    def neg_elbos(train):
        p = jb.merged_params({"train": train, "notrain": params["notrain"]})
        z_key, evolve_key = jax.random.split(key)
        z = p["vd"]["mean"] + jnp.exp(p["vd"]["logdiag"]) * jax.random.normal(z_key, (n, 2))
        w = -j_log_prob(p["vd"], z)
        betas = j_betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])
        z, wd, _ = jod.evolve_overdamped(evolve_key, z, betas, p, ctx, spec,
                                         noise=case["jnoise"])
        return -(w + wd + ctx.target_log_prob(z))

    return neg_elbos


def scan_loss(case):
    """The JAX scan loss of tests/test_pallas_vargrad.py as a function of
    the trainable tree."""
    neg_elbos = scan_neg_elbos(case, jod.CAIS_VAR)
    return lambda train: jnp.clip(jnp.var(neg_elbos(train), ddof=0), -1e7, 1e7)


def torch_value_and_grad(case, loss_fn):
    """loss_fn(params, n, ctx, setup, **draws) under autograd: the loss and
    the gradient of the trainable tree in the JAX layout (zeros where a leaf
    gets none, as jax.grad's)."""
    train = case["params"]["train"]
    for leaf in tree_leaves(train):
        leaf.requires_grad_(True)
        leaf.grad = None
    loss, _ = loss_fn(case["params"], case["n"], case["ctx"], case["setup"], **case["draws"])
    loss.backward()
    return float(loss.detach()), grads_to_numpy(train)


def assert_grads_close(got, want, rel=1e-4, floor=1e-4):
    """The flattened trees and every leaf: |got - want| < rel |want| + floor."""
    got_l, tree_g = jax.tree_util.tree_flatten(got)
    want_l, tree_w = jax.tree_util.tree_flatten(jax.device_get(want))
    assert tree_g == tree_w
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(got)[0]]
    pairs = [(np.asarray(g, np.float64).ravel(), np.asarray(w, np.float64).ravel())
             for g, w in zip(got_l, want_l)]
    for path, (g, w) in zip(paths, pairs):
        assert g.shape == w.shape, path
        assert np.linalg.norm(g - w) < rel * np.linalg.norm(w) + floor, path
    flat_g = np.concatenate([g for g, _ in pairs])
    flat_w = np.concatenate([w for _, w in pairs])
    assert np.linalg.norm(flat_g - flat_w) < rel * np.linalg.norm(flat_w) + floor
    assert np.linalg.norm(flat_w) > 1.0  # a live gradient, not zeros against zeros


@pytest.mark.parametrize("grad_clipping", [True, False])
@pytest.mark.parametrize("eps_schedule", ["", "cos_sq", "linear"])
def test_eager_var_bound_grad_matches_jax_scan(eps_schedule, grad_clipping):
    case = make_case(eps_schedule, grad_clipping)
    want_l, want_g = jax.value_and_grad(scan_loss(case))(case["jparams"]["train"])
    got_l, got_g = torch_value_and_grad(case, tb.var_bound)
    np.testing.assert_allclose(got_l, float(want_l), rtol=1e-4)
    assert_grads_close(got_g, want_g)


def _jax_forward_with_trajectory(case, spec=jod.CAIS_VAR):
    """JAX's fused rollout under `spec` in interpret mode, storing the
    transposed trajectory: (z0, z, w, traj_t, the kernel arguments)."""
    p = jb.merged_params(case["jparams"])
    s = case["jsetup"]
    dim_pad = _dim_pad(2)
    betas = j_betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])
    z0 = p["vd"]["mean"] + jnp.exp(p["vd"]["logdiag"]) * jnp.asarray(
        case["draws"]["base_normals"].numpy())
    sn_w, sn_meta = pack_geffner_t(p["sn"], 2, dim_pad)
    args = (betas, p["eps"], p["vd"]["mean"], p["vd"]["logdiag"],
            grad_t_for_target(case["jt"], dim_pad), spec)
    kw = dict(dim=2, nbridges=case["k"], sn_weights=sn_w, sn_meta=sn_meta,
              eps_schedule=s.eps_schedule, grad_clipping=s.grad_clipping, block=128,
              interpret=True)
    z, w, traj_t = evolve_overdamped_pallas(
        z0, jnp.zeros(case["n"]), *args, noise=case["jnoise"], return_trajectory_t=True, **kw)
    return z0, z, w, traj_t, args, kw


def _port_rollout_args(case, spec=tod.CAIS_VAR):
    p = tb.merged_params(case["params"])
    betas = betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"]).detach()
    args = (betas, p["eps"].detach(), p["vd"]["mean"].detach(), p["vd"]["logdiag"].detach(),
            make_many_gmm_score("cpu"), spec)
    s = case["setup"]
    kw = dict(dim=2, nbridges=case["k"], sn=p["sn"], eps_schedule=s.eps_schedule,
              grad_clipping=s.grad_clipping)
    return args, kw


@pytest.mark.parametrize("eps_schedule", ["", "cos_sq"])
def test_rollout_trajectory_matches_jax_kernel(eps_schedule):
    case = make_case(eps_schedule)
    z0_j, z_j, w_j, traj_t, _, _ = _jax_forward_with_trajectory(case)
    args, kw = _port_rollout_args(case)
    z0 = torch.from_numpy(np.array(z0_j))
    z, w, traj = evolve_overdamped_fused(z0, torch.zeros(case["n"]), *args,
                                         noise=case["draws"]["noise"],
                                         return_trajectory=True, **kw)
    assert traj.shape == (K + 1, N, 2)
    assert torch.equal(traj[0], z0) and torch.equal(traj[K], z)
    want = np.asarray(traj_t)[:, :2, :N].transpose(0, 2, 1)
    np.testing.assert_allclose(traj.numpy(), want, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=5e-4, rtol=1e-4)


def _port_replay_to_jax_layout(case, g):
    """A port gradient dict of the replay backward as the JAX kernel's:
    eps, betas, vd_mean, vd_logdiag and the geffner tree."""
    sn = case["params"]["train"]["sn"]
    for name, p in sn.named_parameters():
        p.grad = g["sn"][name]
    return {"eps": g["eps"].numpy(), "betas": g["betas"].numpy(),
            "vd_mean": g["vd_mean"].numpy(), "vd_logdiag": g["vd_logdiag"].numpy(),
            "sn": grads_to_numpy(sn)}


@pytest.mark.parametrize("eps_schedule,grad_clipping",
                         [("", True), ("cos_sq", True), ("linear", True), ("", False)])
def test_replay_plain_matches_jax_replay_kernel(eps_schedule, grad_clipping):
    case = make_case(eps_schedule, grad_clipping)
    _, _, _, traj_t, j_args, j_kw = _jax_forward_with_trajectory(case)
    cot = case["rng"].standard_normal(N).astype(np.float32)
    want = j_replay(traj_t, jnp.asarray(cot), *j_args, n_chains=N, **j_kw)
    traj = torch.from_numpy(np.ascontiguousarray(
        np.asarray(traj_t)[:, :2, :N].transpose(0, 2, 1)))
    args, kw = _port_rollout_args(case)
    before = evolve_vargrad_bwd_replay.launches
    got = evolve_vargrad_bwd_replay(traj, torch.from_numpy(cot), *args, **kw)
    assert evolve_vargrad_bwd_replay.launches == before  # no kernel on a CPU tensor
    got = _port_replay_to_jax_layout(case, got)
    if eps_schedule == "linear":
        # The Pallas kernel's d eps is NaN under "linear": at the masked point
        # j = K its step size extrapolates below zero and the 1e-30 floor's
        # 0 * inf reaches the gradient. The port masks before dividing; its
        # d eps under "linear" is held by the oracle tests instead.
        want = dict(jax.device_get(want))
        assert np.isnan(want["eps"]) and np.isfinite(got["eps"])
        want["eps"] = got["eps"]
    assert_grads_close(got, want)


# n = 100: no multiple of the kernels' chain tiles. "linear": against the
# oracle only (the Pallas backward's d eps is NaN there, see above).
@pytest.mark.parametrize("n,eps_schedule", [(N, ""), (100, ""), (N, "linear")])
def test_var_bound_fused_matches_oracle_and_jax_fused(n, eps_schedule):
    case = make_case(eps_schedule, n=n)

    def pallas_loss(train):
        return var_bound_pallas(
            {"train": train, "notrain": case["jparams"]["notrain"]}, case["key"], n,
            case["jctx"], case["jsetup"], case["jt"], block=128, noise=case["jnoise"],
            interpret=True, backward="replay")[0]

    fused = lambda p, n_, c, s, **d: var_bound_fused(p, n_, c, s, case["target"], **d)
    got_l, got_g = torch_value_and_grad(case, fused)
    oracle_l, oracle_g = torch_value_and_grad(case, tb.var_bound)
    np.testing.assert_allclose(got_l, oracle_l, rtol=1e-4)
    assert_grads_close(got_g, oracle_g)
    if eps_schedule != "linear":
        want_l, want_g = jax.value_and_grad(pallas_loss)(case["jparams"]["train"])
        np.testing.assert_allclose(got_l, float(want_l), rtol=1e-4)
        assert_grads_close(got_g, want_g)


def test_var_bound_fused_cuts_the_states_from_the_graph():
    case = make_case()
    base = case["draws"]["base_normals"].clone().requires_grad_(True)
    loss, (neg, z) = var_bound_fused(case["params"], N, case["ctx"], case["setup"],
                                     case["target"], base_normals=base,
                                     noise=case["draws"]["noise"])
    assert not z.requires_grad and neg.requires_grad
    # z0 reaches the loss through -log q(z0) only, which does not depend on
    # the base normals' direction through the rollout: its gradient is that
    # of -0.5 |base|^2 weighted by the variance's cotangent.
    (g_base,) = torch.autograd.grad(loss, base)
    cot = 2.0 * (neg - neg.mean()) / N
    np.testing.assert_allclose(g_base.numpy(), (-cot[:, None] * base).detach().numpy(),
                               rtol=1e-4, atol=1e-5)


def test_supports_fused_train_gate():
    target = load_target("many_gmm", device="cpu")
    assert supports_fused_train(
        tb.CMCDSetup(mode="MCD_CAIS_var_sn", dim=2, nbridges=256, emb_dim=130), target)
    # The KL twin trains through the reverse-sweep kernel, and so do ULA_sn
    # (the sweep's per-point form) and DNF (its two-net form), DNF with the
    # geffner nets only.
    assert supports_fused_train(
        tb.CMCDSetup(mode="MCD_CAIS_sn", dim=2, nbridges=8), target)
    assert supports_fused_train(
        tb.CMCDSetup(mode="MCD_ULA_sn", dim=2, nbridges=8), target)
    assert supports_fused_train(
        tb.CMCDSetup(mode="MCD_DNF", dim=2, nbridges=8), target)
    assert not supports_fused_train(
        tb.CMCDSetup(mode="MCD_DNF", dim=2, nbridges=8, nn_arch="dds",
                     fully_connected_units=(16, 16)), target)
    # in_dim 162 fits the rollout's block but not the backward's (many_gmm:
    # 80 constants, its 40 means).
    assert kernel_fits(132, 80, 2) and kernel_fits(144, 80, 2) and not kernel_fits(148, 80, 2)
    assert not supports_fused_train(
        tb.CMCDSetup(mode="MCD_CAIS_var_sn", dim=2, nbridges=8, emb_dim=160), target)


@pytest.mark.parametrize("bad", ["spec", "score", "shape", "schedule"])
def test_replay_wrapper_refuses_what_the_kernel_does_not_take(bad):
    case = make_case()
    (betas, eps, mean, logdiag, score, spec), kw = _port_rollout_args(case)
    traj, cot = torch.zeros(K + 1, N, 2), torch.zeros(N)
    if bad == "spec":
        spec = tod.ULA_SN
    elif bad == "score":
        score = lambda z: -z
    elif bad == "shape":
        traj = torch.zeros(K, N, 2)
    elif bad == "schedule":
        kw["eps_schedule"] = "exp"
    with pytest.raises((NotImplementedError, ValueError)):
        evolve_vargrad_bwd_replay(traj, cot, betas, eps, mean, logdiag, score, spec, **kw)


def test_replay_plain_has_only_the_factor_gradient_at_factor_zero():
    """factor_sn starts at 0: every inner net gradient is exactly 0 and only
    d factor_sn is live."""
    case = make_case()
    with torch.no_grad():
        case["params"]["train"]["sn"].factor_sn.zero_()
    args, kw = _port_rollout_args(case)
    z0 = case["draws"]["base_normals"] * 15.0
    _, _, traj = evolve_overdamped_fused(z0, torch.zeros(N), *args,
                                         noise=case["draws"]["noise"],
                                         return_trajectory=True, **kw)
    g = evolve_vargrad_bwd_replay_plain(traj, torch.ones(N), *args, **kw)
    assert float(g["sn"]["factor_sn"].abs()) > 0
    for name, grad in g["sn"].items():
        if name != "factor_sn":
            assert float(grad.abs().max()) == 0.0, name


@pytest.mark.parametrize("eps_schedule,grad_clipping",
                         [("", True), ("cos_sq", True), ("linear", True), ("", False)])
def test_reroll_plain_matches_jax_reroll_kernel(eps_schedule, grad_clipping):
    case = make_case(eps_schedule, grad_clipping)
    z0_j, _, _, _, j_args, j_kw = _jax_forward_with_trajectory(case)
    cot = case["rng"].standard_normal(N).astype(np.float32)
    want = j_reroll(z0_j, jnp.asarray(cot), *j_args, noise=case["jnoise"], **j_kw)
    args, kw = _port_rollout_args(case)
    got = evolve_vargrad_bwd_reroll_plain(
        torch.from_numpy(np.array(z0_j)), torch.from_numpy(cot), *args,
        noise=case["draws"]["noise"], **kw)
    got = _port_replay_to_jax_layout(case, got)
    if eps_schedule == "linear":
        # As in the replay kernel: the Pallas kernel's d eps is NaN under
        # "linear" (the masked point j = K); the port's is the oracle's.
        want = dict(jax.device_get(want))
        assert np.isnan(want["eps"]) and np.isfinite(got["eps"])
        want["eps"] = got["eps"]
    assert_grads_close(got, want)


@pytest.mark.parametrize("eps_schedule", ["", "linear"])
def test_reroll_equals_replay_on_the_trajectory_the_same_noise_gives(eps_schedule):
    case = make_case(eps_schedule)
    args, kw = _port_rollout_args(case)
    z0 = 15.0 * case["draws"]["base_normals"]
    noise, cot = case["draws"]["noise"], torch.from_numpy(
        case["rng"].standard_normal(N).astype(np.float32))
    _, _, traj = evolve_overdamped_fused(z0, torch.zeros(N), *args, noise=noise,
                                         return_trajectory=True, **kw)
    before = evolve_vargrad_bwd_reroll.launches
    got = evolve_vargrad_bwd_reroll(z0, cot, *args, noise=noise, **kw)
    assert evolve_vargrad_bwd_reroll.launches == before  # no kernel on a CPU tensor
    want = evolve_vargrad_bwd_replay(traj, cot, *args, **kw)
    for name in ("eps", "betas", "vd_mean", "vd_logdiag"):
        assert torch.equal(got[name], want[name]), name
    for name, grad in want["sn"].items():
        assert torch.equal(got["sn"][name], grad), name
    # From a seed the plain version draws its own normals (torch.randn, not
    # the kernel's Philox): the same seed gives the same gradient again.
    a = evolve_vargrad_bwd_reroll(z0, cot, *args, seed=5, **kw)
    b = evolve_vargrad_bwd_reroll(z0, cot, *args, seed=torch.tensor([5]), **kw)
    c = evolve_vargrad_bwd_reroll(z0, cot, *args, seed=6, **kw)
    assert torch.equal(a["betas"], b["betas"]) and not torch.equal(a["betas"], c["betas"])


@pytest.mark.parametrize("n,eps_schedule", [(N, ""), (100, "cos_sq"), (N, "linear")])
def test_var_bound_fused_reroll_matches_oracle(n, eps_schedule):
    case = make_case(eps_schedule, n=n)
    fused = lambda p, n_, c, s, **d: var_bound_fused(p, n_, c, s, case["target"],
                                                     backward="reroll", **d)
    got_l, got_g = torch_value_and_grad(case, fused)
    oracle_l, oracle_g = torch_value_and_grad(case, tb.var_bound)
    np.testing.assert_allclose(got_l, oracle_l, rtol=1e-4)
    assert_grads_close(got_g, oracle_g)


@pytest.mark.parametrize("budget,want", [(None, "replay"), ((K + 1) * N * 2 * 4, "replay"),
                                         ((K + 1) * N * 2 * 4 - 1, "reroll")])
def test_backward_auto_picks_by_the_trajectory_byte_budget(monkeypatch, budget, want):
    case = make_case()
    ran = []
    for name in ("replay", "reroll"):
        real = getattr(fused_train, f"evolve_vargrad_bwd_{name}")
        monkeypatch.setattr(fused_train, f"evolve_vargrad_bwd_{name}",
                            lambda *a, _n=name, _f=real, **k: (ran.append(_n), _f(*a, **k))[1])
    if budget is None:
        assert fused_train._REPLAY_BYTES_BUDGET == 256 * 1024 * 1024
    else:
        monkeypatch.setattr(fused_train, "_REPLAY_BYTES_BUDGET", budget)
    loss, _ = var_bound_fused(case["params"], N, case["ctx"], case["setup"], case["target"],
                              **case["draws"])
    torch.autograd.grad(loss, case["params"]["train"]["sn"].factor_sn)
    assert ran == [want]
    with pytest.raises(ValueError, match="auto, replay or reroll"):
        var_bound_fused(case["params"], N, case["ctx"], case["setup"], case["target"],
                        backward="rewind", **case["draws"])
