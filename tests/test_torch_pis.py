"""The port's PIS nets ("dds", "dds_grad") against the JAX package, on the
CPU, under the same weights, base normals and injected noise.

Layers, each held to the next: the nets themselves (cmcd_tpu_torch/networks/
pis.py against cmcd_tpu/networks/pis.py: values, input and weight gradients,
zero at init, the clip, t = K unclamped, the time coefficients' bits after
conversion); the eager kl_bound and var_bound under autograd against jax.grad
of the scan loss; the kernels' plain versions with a PIS net (the rollout
B1 in its CAIS and ULA_sn forms, the KL sweep B3 in its carry and per-point
forms, the VarGrad replay B2 and reroll B5) against the JAX package's Pallas
kernels in interpret mode, mirroring tests/test_pallas_kl.py:380 and
tests/test_pallas_vargrad.py:136; the fused losses against JAX's fused
losses; five many_gmm_kl_dds trainer steps at a cut against the JAX trainer;
the inf loss of the recipes' start; the refusals; and the CLI's
--config.fully_connected_units.

The plain versions take a PIS net through its kernel view (ops/nets.py), so
their net gradients are the view's; view_to_param_grads carries them to the
net's parameters with autograd, as the fused losses do.

Tolerances: the nets 1e-5; rollout z, w as tests/test_torch_overdamped.py;
loss rtol 2e-4 and every gradient leaf |g_t - g_j| < 5e-4 |g_j| + 1e-4, the
limit of the JAX tests above (their flattened trees; here also per leaf).
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
from cmcd_tpu.networks import build_score_network as j_build
from cmcd_tpu.ops.fused import _dim_pad, _pack_net
from cmcd_tpu.ops.fused_train import kl_bound_pallas, var_bound_pallas
from cmcd_tpu.ops.pallas_kl import evolve_kl_bwd_pallas
from cmcd_tpu.ops.pallas_overdamped import evolve_overdamped_pallas
from cmcd_tpu.ops.pallas_vargrad import evolve_vargrad_bwd_pallas as j_reroll
from cmcd_tpu.ops.pallas_vargrad import evolve_vargrad_bwd_replay as j_replay
from cmcd_tpu.ops.target_grads import grad_t_for_target
from cmcd_tpu.schedules import betas_from_grid as j_betas_from_grid
from cmcd_tpu.train import trainer as jtrainer
from cmcd_tpu_torch import bounds as tb
from cmcd_tpu_torch.integrators import overdamped as tod
from cmcd_tpu_torch.main import parse_flags, run_experiment
from cmcd_tpu_torch.networks import GeffnerNet, PISGradNet, PISNet, build_score_network
from cmcd_tpu_torch.ops import nets, overdamped
from cmcd_tpu_torch.ops.fused import supports_fused
from cmcd_tpu_torch.ops.fused_train import (
    fused_training_path,
    kl_bound_fused,
    supports_fused_train,
    var_bound_fused,
)
from cmcd_tpu_torch.ops.kl import evolve_kl_bwd
from cmcd_tpu_torch.ops.overdamped import evolve_overdamped_fused
from cmcd_tpu_torch.ops.target_grads import score_for_target
from cmcd_tpu_torch.ops.vargrad import evolve_vargrad_bwd_replay, evolve_vargrad_bwd_reroll
from cmcd_tpu_torch.schedules import betas_from_grid
from cmcd_tpu_torch.targets import load_target
from cmcd_tpu_torch.train import train
from cmcd_tpu_torch.utils.convert import (
    grads_to_numpy,
    params_from_jax,
    params_to_numpy,
    pis_from_jax,
    pis_to_numpy,
)
from test_torch_vargrad import assert_grads_close, torch_value_and_grad

torch.set_num_threads(1)

K, N = 5, 96
ARCHS = ["dds", "dds_grad"]
KL_REL, LOSS_RTOL = 5e-4, 2e-4


def jax_coeff(channels):
    """The JAX nets' time coefficients (a closure constant of their apply)."""
    return np.asarray(jnp.linspace(0.1, 100.0, channels))


def _randomise(sn, arch, seed=9):
    """Live output layers (zero at init), as the JAX tests do, and a phase
    away from zero."""
    sn["state_net"][-1]["w"] = 0.05 * jax.random.normal(
        jax.random.PRNGKey(seed), sn["state_net"][-1]["w"].shape)
    sn["timestep_phase"] = 0.3 * jax.random.normal(
        jax.random.PRNGKey(seed + 2), sn["timestep_phase"].shape)
    if arch == "dds_grad":
        sn["time_coder_grad"][-1]["w"] = 0.05 * jax.random.normal(
            jax.random.PRNGKey(seed + 1), sn["time_coder_grad"][-1]["w"].shape)


def make_case(mode="MCD_CAIS_sn", arch="dds", target="many_gmm", n=N, k=K, units=(16, 16),
              sigma=8.0, eps=0.1, eps_schedule="", grad_clipping=True, train_vi=True,
              train_eps=True):
    """One problem in both packages with a PIS net: live output layers,
    non-uniform beta knots, an off-centre variational mean."""
    jt = cmcd_tpu.load_target(target)
    dim = jt.dim
    kw = dict(mode=mode, dim=dim, nbridges=k, nn_arch=arch, fully_connected_units=tuple(units),
              grad_clipping=grad_clipping, eps_schedule=eps_schedule)
    jsetup = jb.CMCDSetup(**kw)
    trainable = jb.default_trainable(mode, train_eps=train_eps, train_vi=train_vi)
    params, jctx = jb.initialize(jsetup, jt.log_prob, eps=eps, init_sigma=sigma,
                                 trainable=trainable)
    _randomise(params["train"]["sn"], arch)
    params["train"]["mgridref_y"] = jax.random.uniform(
        jax.random.PRNGKey(4), params["train"]["mgridref_y"].shape, minval=0.5, maxval=1.5)
    vd = params["train" if "vd" in params["train"] else "notrain"]["vd"]
    vd["mean"] = jnp.asarray([0.5 * (-1) ** d for d in range(dim)], jnp.float32)
    key = jax.random.PRNGKey(0)
    base = np.array(jax.random.normal(jax.random.split(key)[0], (n, dim)))
    rng = np.random.default_rng(2)
    noise = rng.standard_normal((k, n, dim)).astype(np.float32)
    tgt = load_target(target, device="cpu")
    tsetup = tb.CMCDSetup(**kw)
    _, tctx = tb.initialize(tsetup, tgt.log_prob, device="cpu")
    port = params_from_jax(jax.device_get(params), device="cpu",
                           pis_coeff=jax_coeff(units[0]), target_log_prob=tgt.log_prob)
    return {
        "jt": jt, "jsetup": jsetup, "jparams": params, "jctx": jctx, "key": key,
        "jbase": jnp.asarray(base), "jnoise": jnp.asarray(noise), "n": n, "k": k, "dim": dim,
        "rng": rng, "target": tgt, "setup": tsetup, "ctx": tctx, "params": port,
        "trainable": trainable,
        "draws": {"base_normals": torch.from_numpy(base), "noise": torch.from_numpy(noise)},
    }


def scan_neg_elbos(case, spec):
    """The JAX scan integrator's negative ELBOs as a function of the
    trainable tree."""
    def neg_elbos(train):
        p = jb.merged_params({"train": train, "notrain": case["jparams"]["notrain"]})
        z = p["vd"]["mean"] + jnp.exp(p["vd"]["logdiag"]) * case["jbase"]
        w = -j_log_prob(p["vd"], z)
        betas = j_betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])
        z, wd, _ = jod.evolve_overdamped(jax.random.split(case["key"])[1], z, betas, p,
                                         case["jctx"], spec, noise=case["jnoise"])
        return -(w + wd + case["jctx"].target_log_prob(z))

    return neg_elbos


def view_to_param_grads(sn, k, g_view):
    """A plain version's gradients in a PIS net's kernel view, carried to its
    parameters (autograd through ops/nets.pis_view), in the JAX layout."""
    names, view = nets.function_inputs(sn, k)
    params = list(sn.parameters())
    grads = torch.autograd.grad(view, params, [g_view[name] for name in names],
                                allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = g
    out = grads_to_numpy(sn)
    for p in params:
        p.grad = None
    return out


def in_jax_layout(case, g):
    sn = case["params"]["train"]["sn"]
    return {"eps": g["eps"].numpy(), "betas": g["betas"].numpy(),
            "vd_mean": g["vd_mean"].numpy(), "vd_logdiag": g["vd_logdiag"].numpy(),
            "sn": view_to_param_grads(sn, case["k"], g["sn"])}


def jax_kernel_args(case, spec):
    """The JAX kernels' arguments for the case (interpret mode)."""
    p = jb.merged_params(case["jparams"])
    s, dim = case["jsetup"], case["dim"]
    dim_pad = _dim_pad(dim)
    betas = j_betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])
    sn_w, sn_meta = _pack_net(s.nn_arch)(p["sn"], dim, dim_pad)
    z0 = p["vd"]["mean"] + jnp.exp(p["vd"]["logdiag"]) * case["jbase"]
    args = (betas, p["eps"], p["vd"]["mean"], p["vd"]["logdiag"],
            grad_t_for_target(case["jt"], dim_pad), spec)
    kw = dict(dim=dim, nbridges=case["k"], sn_weights=sn_w, sn_meta=sn_meta,
              eps_schedule=s.eps_schedule, grad_clipping=s.grad_clipping, block=128,
              interpret=True)
    return z0, args, kw


def port_args(case, spec):
    p = tb.merged_params(case["params"])
    betas = betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"]).detach()
    z0 = (p["vd"]["mean"] + torch.exp(p["vd"]["logdiag"]) * case["draws"]["base_normals"]).detach()
    args = (betas, p["eps"].detach(), p["vd"]["mean"].detach(), p["vd"]["logdiag"].detach(),
            score_for_target(case["target"], "cpu"), spec)
    s = case["setup"]
    kw = dict(dim=case["dim"], nbridges=case["k"], sn=p["sn"], eps_schedule=s.eps_schedule,
              grad_clipping=s.grad_clipping)
    return z0, args, kw


def untranspose(case, traj_t):
    n, dim = case["n"], case["dim"]
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(traj_t)[:, :dim, :n].transpose(0, 2, 1)))


# --- the nets ---------------------------------------------------------------

@pytest.mark.parametrize("arch,units", [("dds", (16, 16)), ("dds_grad", (16, 16)),
                                        ("dds", (64, 64)), ("dds_grad", (32, 32, 32))])
def test_pis_net_matches_jax_values_and_gradients(arch, units):
    jt = cmcd_tpu.load_target("many_gmm")
    tt = load_target("many_gmm", device="cpu")
    init, apply = j_build(2, 20, K, arch=arch, fully_connected_units=list(units),
                          target_log_prob=jt.log_prob)
    sn = init(jax.random.PRNGKey(1))
    _randomise(sn, arch)
    sn = jax.device_get(sn)
    net = pis_from_jax(sn, "cpu", jax_coeff(units[0]), tt.log_prob)
    assert type(net) is (PISGradNet if arch == "dds_grad" else PISNet)
    assert np.array_equal(net.coeff.numpy(), jax_coeff(units[0]))
    rng = np.random.default_rng(3)
    x = rng.normal(0, 8, (32, 2)).astype(np.float32)
    v = rng.normal(0, 1, (32, 2)).astype(np.float32)
    for t in (0, 3, K):
        def j_obj(p, xx):
            return jnp.sum(apply(p, xx, t) * v)
        want = np.asarray(apply(jax.tree_util.tree_map(jnp.asarray, sn), jnp.asarray(x), t))
        gw, gx = jax.grad(j_obj, argnums=(0, 1))(jax.tree_util.tree_map(jnp.asarray, sn),
                                                 jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_(True)
        for p in net.parameters():
            p.grad = None
        out = net(xt, t)
        np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5, atol=1e-6)
        (out * torch.from_numpy(v)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5, atol=1e-6)
        got_l, got_def = jax.tree_util.tree_flatten(grads_to_numpy(net))
        want_l, want_def = jax.tree_util.tree_flatten(jax.device_get(gw))
        assert got_def == want_def
        for g, w in zip(got_l, want_l):
            assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w) + 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_pis_net_starts_at_zero_clips_and_round_trips(arch):
    tt = load_target("many_gmm", device="cpu")
    net, apply = build_score_network(2, 20, K, arch=arch, fully_connected_units=[16, 16],
                                     generator=torch.Generator().manual_seed(0),
                                     target_log_prob=tt.log_prob)
    x = 8.0 * torch.randn(16, 2, generator=torch.Generator().manual_seed(1))
    assert torch.all(apply(net, x, 2) == 0)
    # The output clip: a huge last layer saturates at +-1e4 in both packages.
    jt = cmcd_tpu.load_target("many_gmm")
    init, j_apply = j_build(2, 20, K, arch=arch, fully_connected_units=[16, 16],
                            target_log_prob=jt.log_prob)
    sn = init(jax.random.PRNGKey(2))
    sn["state_net"][-1]["w"] = 1e6 * jnp.ones_like(sn["state_net"][-1]["w"])
    sn = jax.device_get(sn)
    net = pis_from_jax(sn, "cpu", jax_coeff(16), tt.log_prob)
    out = net(x, 1).detach()
    if arch == "dds":
        assert float(out.abs().max()) == 1e4
    np.testing.assert_allclose(out.numpy(), np.asarray(j_apply(sn, jnp.asarray(x.numpy()), 1)),
                               rtol=1e-6)
    # Round trip: the JAX tree's leaves, in jax.grad's order.
    got_l, got_def = jax.tree_util.tree_flatten(pis_to_numpy(net))
    want_l, want_def = jax.tree_util.tree_flatten(sn)
    assert got_def == want_def
    assert all(np.array_equal(g, w) for g, w in zip(got_l, want_l))


def test_time_is_not_clamped_and_the_factory_dispatches():
    tt = load_target("many_gmm", device="cpu")
    case = make_case(arch="dds")
    net = case["params"]["train"]["sn"]
    x = torch.randn(8, 2, generator=torch.Generator().manual_seed(4))
    assert not torch.allclose(net(x, K), net(x, K - 1))
    assert nets.net_row(net, K, K) == K
    geffner, _ = build_score_network(2, 16, K)
    assert isinstance(geffner, GeffnerNet) and nets.net_row(geffner, K, K) == K - 1
    assert nets.pis_view(net, K)["c1"].shape == (K + 1, 16)
    with pytest.raises(ValueError, match="target_log_prob"):
        build_score_network(2, 20, K, arch="dds_grad")
    grad_net, _ = build_score_network(2, 20, K, arch="dds_grad", target_log_prob=tt.log_prob,
                                      fully_connected_units=[16, 16])
    assert isinstance(grad_net, PISGradNet) and len(grad_net.time_coder_grad) == 4


def test_fresh_time_coefficients_lie_within_two_ulp_of_jax():
    """A fresh port net's coefficients (float64 linspace rounded once) and
    jnp.linspace's float32 ones: at most two ulp apart (the converter
    carries JAX's bits where both packages must agree)."""
    got = PISNet(2, (64, 64)).coeff.numpy()
    want = jax_coeff(64)
    assert np.all(np.abs(got - want) <= 2 * np.spacing(np.abs(want)))
    assert float(np.abs(got - want).max()) <= 7.7e-6


# --- the eager losses against the scan path -------------------------------

@pytest.mark.parametrize("loss,arch,target", [
    ("kl", "dds", "many_gmm"), ("kl", "dds_grad", "many_gmm"),
    ("var", "dds", "many_gmm"), ("var", "dds_grad", "many_gmm"),
    ("kl", "dds", "funnel"), ("kl", "dds_grad", "funnel")])
def test_eager_losses_match_jax_scan(loss, arch, target):
    mode = "MCD_CAIS_sn" if loss == "kl" else "MCD_CAIS_var_sn"
    case = make_case(mode, arch, target, n=64, sigma=8.0 if target == "many_gmm" else 1.0,
                     eps_schedule="cos_sq")
    spec = jod.CAIS if loss == "kl" else jod.CAIS_VAR
    neg = scan_neg_elbos(case, spec)
    j_loss = ((lambda tr: jnp.mean(neg(tr))) if loss == "kl"
              else (lambda tr: jnp.clip(jnp.var(neg(tr), ddof=0), -1e7, 1e7)))
    want_l, want_g = jax.value_and_grad(j_loss)(case["jparams"]["train"])
    got_l, got_g = torch_value_and_grad(case, tb.kl_bound if loss == "kl" else tb.var_bound)
    np.testing.assert_allclose(got_l, float(want_l), rtol=LOSS_RTOL)
    assert_grads_close(got_g, want_g, rel=KL_REL)


# --- the plain versions of the kernels against JAX's Pallas kernels --------

@pytest.mark.parametrize("form,arch,target", [
    ("CAIS", "dds", "many_gmm"), ("CAIS", "dds_grad", "many_gmm"),
    ("ULA_sn", "dds", "many_gmm"), ("ULA_sn", "dds_grad", "many_gmm"),
    ("CAIS", "dds_grad", "funnel"), ("ULA_sn", "dds", "funnel")])
def test_rollout_plain_matches_jax_kernel(form, arch, target):
    spec_j, spec_t = {"CAIS": (jod.CAIS, tod.CAIS), "ULA_sn": (jod.ULA_SN, tod.ULA_SN)}[form]
    mode = "MCD_CAIS_sn" if form == "CAIS" else "MCD_ULA_sn"
    case = make_case(mode, arch, target, sigma=8.0 if target == "many_gmm" else 1.0)
    z0_j, j_args, j_kw = jax_kernel_args(case, spec_j)
    z_j, w_j, traj_t = evolve_overdamped_pallas(z0_j, jnp.zeros(case["n"]), *j_args,
                                                noise=case["jnoise"], return_trajectory_t=True,
                                                **j_kw)
    z0, args, kw = port_args(case, spec_t)
    before = evolve_overdamped_fused.launches
    z, w, traj = evolve_overdamped_fused(z0, torch.zeros(case["n"]), *args,
                                         noise=case["draws"]["noise"], return_trajectory=True,
                                         **kw)
    assert evolve_overdamped_fused.launches == before  # the plain version on a CPU tensor
    np.testing.assert_allclose(traj.numpy(), untranspose(case, traj_t).numpy(), atol=2e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=5e-4, rtol=1e-4)


def test_a_pis_row_clamped_to_k_minus_1_would_fail():
    """The CAIS backward net of the last step runs at t = K. The port's
    plain rollout agrees with JAX's kernel; the same rollout with the view's
    row K replaced by row K - 1 (geffner's clamp) is far outside the limit."""
    case = make_case("MCD_CAIS_sn", "dds_grad", units=(16, 16))
    z0_j, j_args, j_kw = jax_kernel_args(case, jod.CAIS)
    _, w_j, _ = evolve_overdamped_pallas(z0_j, jnp.zeros(case["n"]), *j_args,
                                         noise=case["jnoise"], return_trajectory_t=True, **j_kw)
    z0, args, kw = port_args(case, tod.CAIS)
    run = lambda: evolve_overdamped_fused(z0, torch.zeros(case["n"]), *args,
                                          noise=case["draws"]["noise"], **kw)[1].numpy()
    w = run()
    np.testing.assert_allclose(w, np.asarray(w_j), atol=5e-4, rtol=1e-4)
    view = nets.pis_view

    def clamped(sn, k, dtype=torch.float32):
        v = view(sn, k, dtype)
        return {**v, "c1": torch.cat([v["c1"][:k], v["c1"][k - 1:k]]),
                "gate": torch.cat([v["gate"][:k], v["gate"][k - 1:k]])}

    try:
        nets.pis_view = clamped
        w_clamped = run()
    finally:
        nets.pis_view = view
    beyond = np.abs(w_clamped - np.asarray(w_j)) / (5e-4 + 1e-4 * np.abs(np.asarray(w_j)))
    assert beyond.max() > 100


@pytest.mark.parametrize("form,arch,target", [
    ("CAIS", "dds", "many_gmm"), ("CAIS", "dds_grad", "many_gmm"),
    ("ULA_sn", "dds", "many_gmm"), ("ULA_sn", "dds_grad", "many_gmm"),
    ("CAIS", "dds_grad", "funnel")])
def test_sweep_plain_matches_jax_sweep_kernel(form, arch, target):
    spec_j, spec_t = {"CAIS": (jod.CAIS, tod.CAIS), "ULA_sn": (jod.ULA_SN, tod.ULA_SN)}[form]
    mode = "MCD_CAIS_sn" if form == "CAIS" else "MCD_ULA_sn"
    case = make_case(mode, arch, target, sigma=8.0 if target == "many_gmm" else 1.0,
                     eps_schedule="cos_sq")
    n, dim = case["n"], case["dim"]
    z0_j, j_args, j_kw = jax_kernel_args(case, spec_j)
    _, _, traj_t = evolve_overdamped_pallas(z0_j, jnp.zeros(n), *j_args, noise=case["jnoise"],
                                            return_trajectory_t=True, **j_kw)
    noise_t = jnp.zeros((case["k"], _dim_pad(dim), traj_t.shape[2]), jnp.float32).at[
        :, :dim, :n].set(jnp.swapaxes(case["jnoise"], 1, 2))
    cot = case["rng"].standard_normal(n).astype(np.float32)
    g_zf = case["rng"].standard_normal((n, dim)).astype(np.float32)
    want, want_z0 = evolve_kl_bwd_pallas(traj_t, noise_t, jnp.asarray(cot), jnp.asarray(g_zf),
                                         *j_args, n_chains=n, **j_kw)
    _, args, kw = port_args(case, spec_t)
    got, got_z0 = evolve_kl_bwd(untranspose(case, traj_t), case["draws"]["noise"],
                                torch.from_numpy(cot), torch.from_numpy(g_zf), *args, **kw)
    assert set(got["sn"]) == set(nets.function_inputs(kw["sn"], case["k"])[0])
    assert_grads_close(in_jax_layout(case, got), jax.device_get(want), rel=KL_REL)
    want_z0 = np.asarray(want_z0)
    assert np.linalg.norm(got_z0.numpy() - want_z0) < KL_REL * np.linalg.norm(want_z0) + 1e-4


@pytest.mark.parametrize("arch,target", [("dds", "many_gmm"), ("dds_grad", "many_gmm"),
                                         ("dds_grad", "funnel")])
def test_vargrad_plain_backwards_match_jax_kernels(arch, target):
    case = make_case("MCD_CAIS_var_sn", arch, target, n=128,
                     sigma=8.0 if target == "many_gmm" else 1.0)
    n = case["n"]
    z0_j, j_args, j_kw = jax_kernel_args(case, jod.CAIS_VAR)
    _, _, traj_t = evolve_overdamped_pallas(z0_j, jnp.zeros(n), *j_args, noise=case["jnoise"],
                                            return_trajectory_t=True, **j_kw)
    cot = case["rng"].standard_normal(n).astype(np.float32)
    z0, args, kw = port_args(case, tod.CAIS_VAR)
    want = j_replay(traj_t, jnp.asarray(cot), *j_args, n_chains=n, **j_kw)
    got = evolve_vargrad_bwd_replay(untranspose(case, traj_t), torch.from_numpy(cot), *args,
                                    **kw)
    assert_grads_close(in_jax_layout(case, got), jax.device_get(want), rel=KL_REL)
    want = j_reroll(z0_j, jnp.asarray(cot), *j_args, noise=case["jnoise"], **j_kw)
    got = evolve_vargrad_bwd_reroll(z0, torch.from_numpy(cot), *args,
                                    noise=case["draws"]["noise"], **kw)
    assert_grads_close(in_jax_layout(case, got), jax.device_get(want), rel=KL_REL)


# --- the fused losses -------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_kl_bound_fused_matches_jax_pallas_loss(arch):
    """tests/test_pallas_kl.py:380's case (N=96, K=5, init_sigma 8, grad
    clipping) through the port's fused KL loss (plain versions)."""
    case = make_case("MCD_CAIS_sn", arch)

    def pallas_loss(train):
        return kl_bound_pallas({"train": train, "notrain": case["jparams"]["notrain"]},
                               case["key"], N, case["jctx"], case["jsetup"], case["jt"],
                               block=128, noise=case["jnoise"], interpret=True)[0]

    fused = lambda p, n_, c, s, **d: kl_bound_fused(p, n_, c, s, case["target"], **d)
    got_l, got_g = torch_value_and_grad(case, fused)
    want_l, want_g = jax.value_and_grad(pallas_loss)(case["jparams"]["train"])
    np.testing.assert_allclose(got_l, float(want_l), rtol=LOSS_RTOL)
    assert_grads_close(got_g, want_g, rel=KL_REL)
    oracle_l, oracle_g = torch_value_and_grad(case, tb.kl_bound)
    np.testing.assert_allclose(got_l, oracle_l, rtol=LOSS_RTOL)
    assert_grads_close(got_g, oracle_g, rel=KL_REL)


@pytest.mark.parametrize("arch,backward", [("dds", "replay"), ("dds", "reroll"),
                                           ("dds_grad", "replay")])
def test_var_bound_fused_matches_jax_pallas_loss(arch, backward):
    """tests/test_pallas_vargrad.py:136's cases through the port's fused
    VarGrad loss (plain versions)."""
    case = make_case("MCD_CAIS_var_sn", arch)

    def pallas_loss(train):
        return var_bound_pallas({"train": train, "notrain": case["jparams"]["notrain"]},
                                case["key"], N, case["jctx"], case["jsetup"], case["jt"],
                                block=128, noise=case["jnoise"], interpret=True,
                                backward=backward)[0]

    fused = lambda p, n_, c, s, **d: var_bound_fused(p, n_, c, s, case["target"],
                                                     backward=backward, **d)
    got_l, got_g = torch_value_and_grad(case, fused)
    want_l, want_g = jax.value_and_grad(pallas_loss)(case["jparams"]["train"])
    np.testing.assert_allclose(got_l, float(want_l), rtol=LOSS_RTOL)
    assert_grads_close(got_g, want_g, rel=KL_REL)


STEPS = 5
# many_gmm_kl_dds (experiments/recipes.py:108-128) cut to N=64, K=8.
KL_DDS = dict(mode="MCD_CAIS_sn", arch="dds", n=64, k=8, units=(64, 64), sigma=60.0, eps=1.0,
              eps_schedule="cos_sq", grad_clipping=True, train_vi=False, train_eps=False)


def test_five_many_gmm_kl_dds_steps_match_the_jax_trainer():
    """many_gmm_kl_dds's flags at N=64, K=8: the JAX trainer on its fused KL
    loss (interpret mode) and the port's trainer on its fused KL loss (plain
    versions) under the same draws: losses (+inf where a chain ends past
    many_gmm's floor) and every parameter after five Adam steps."""
    case = make_case(**KL_DDS)
    n, k = case["n"], case["k"]
    rng = np.random.default_rng(11)
    key = jax.random.PRNGKey(0)
    step_keys = []
    for _ in range(STEPS):  # the JAX trainer's keys, one a step
        key, step_key = jax.random.split(key)
        step_keys.append(step_key)
    # kl_bound_pallas draws the base normals from split(key)[0]; the noise
    # is injected.
    draws = [(np.array(jax.random.normal(jax.random.split(sk)[0], (n, 2)), np.float32),
              rng.standard_normal((k, n, 2)).astype(np.float32)) for sk in step_keys]
    step_keys = jnp.stack(step_keys)
    noise_all = jnp.asarray(np.stack([d[1] for d in draws]))

    def j_loss(full, step_key, n_, ctx, setup):
        t = jnp.argmax(jnp.all(step_keys == step_key, axis=-1))
        return kl_bound_pallas(full, step_key, n_, ctx, setup, case["jt"], block=128,
                               noise=noise_all[t], interpret=True)

    trainable = case["trainable"]
    want = jtrainer.train(case["jsetup"], case["jparams"], case["jctx"], lr=0.001, iters=STEPS,
                          batch_size=n, key=jax.random.PRNGKey(0), trainable=trainable,
                          loss_fn=j_loss, log_every=1, steps_per_call=1)
    step = {"i": 0}

    def loss_fn(params, n_, ctx, setup, generator=None):
        base, noise = draws[step["i"]]
        step["i"] += 1
        return kl_bound_fused(params, n_, ctx, setup, case["target"],
                              base_normals=torch.from_numpy(base), noise=torch.from_numpy(noise))

    got = train(case["setup"], case["params"], case["ctx"], lr=0.001, iters=STEPS,
                batch_size=n, trainable=trainable, loss_fn=loss_fn, log_every=1)
    assert got.steps_done == STEPS and not got.diverged and not bool(want.diverged)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses), rtol=1e-4)
    got_l, treedef = jax.tree_util.tree_flatten(params_to_numpy(got.params["train"]))
    want_l, want_def = jax.tree_util.tree_flatten(jax.device_get(want.params["train"]))
    init_l = jax.tree_util.tree_leaves(jax.device_get(case["jparams"]["train"]))
    assert treedef == want_def
    # Adam moves an element by about lr a step whatever its gradient's size,
    # so the float32 rounding of a near-zero gradient element (the leaves
    # agree to 4e-6 at a step) moves it as far as a large one: per leaf the
    # root mean square of the two trainers' difference within 1% of the five
    # steps' path, and no element beyond 10% of it.
    path = 0.001 * STEPS
    for g, w in zip(got_l, want_l):
        assert np.sqrt(np.mean((g - w) ** 2)) <= 0.01 * path and np.abs(g - w).max() <= 0.1 * path
    assert any(not np.allclose(w, w0) for w, w0 in zip(want_l, init_l))


# --- the inf loss of the recipes' start ------------------------------------

def test_inf_loss_trains_through_like_reference():
    """tests/test_trainer.py:65 in the port: a loss whose value is +inf with
    a finite gradient trains on (the guard checks NaN, not finiteness), in
    both trainers alike."""
    from cmcd_tpu.train import train as j_train

    jt = cmcd_tpu.load_target("many_gmm")
    jsetup = jb.CMCDSetup(mode="MCD_ULA", dim=2, nbridges=2)
    jparams, jctx = jb.initialize(jsetup, jt.log_prob, eps=0.3, trainable=("eps",))

    def j_inf_loss(params, key, n, ctx, setup):
        finite = jnp.sum(params["train"]["eps"] ** 2)
        neg = jnp.full((n,), jnp.inf).at[0].set(finite)
        return jnp.mean(neg), (neg, jnp.zeros((n, 2)))

    want = j_train(jsetup, jparams, jctx, lr=1e-2, iters=20, batch_size=8,
                   key=jax.random.PRNGKey(0), trainable=("eps",), loss_fn=j_inf_loss,
                   nan_check_every=1)
    target = load_target("many_gmm", device="cpu")
    setup = tb.CMCDSetup(mode="MCD_ULA", dim=2, nbridges=2)
    params, ctx = tb.initialize(setup, target.log_prob, eps=0.3, trainable=("eps",),
                                device="cpu")

    def inf_loss(p, n, ctx_, setup_, generator=None):
        finite = torch.sum(p["train"]["eps"] ** 2)
        neg = torch.cat([finite.reshape(1), torch.full((n - 1,), float("inf"))])
        return torch.mean(neg), (neg, torch.zeros(n, 2))

    got = train(setup, params, ctx, lr=1e-2, iters=20, batch_size=8, trainable=("eps",),
                loss_fn=inf_loss, nan_check_every=1)
    assert not got.diverged and got.steps_done == 20 and not bool(want.diverged)
    assert bool(torch.isinf(got.losses).all())
    assert float(got.params["train"]["eps"]) < 0.3
    # Twenty Adam steps in float32 in each package: 1e-4.
    np.testing.assert_allclose(float(got.params["train"]["eps"]),
                               float(want.params["train"]["eps"]), rtol=1e-4)


def test_the_recipe_start_has_an_inf_loss_and_finite_gradients():
    """many_gmm_kl_dds starts at init_sigma 60 with chains past many_gmm's
    -1e4 floor. The eager loss (the scan path's counterpart: the drift is
    autograd of the floored log-prob, 0 there) leaves them there: the loss
    is +inf in both packages, every gradient leaf finite and equal, and
    training goes on and moves the net. The kernels' score ignores the floor
    (as JAX's Pallas kernels'), so the fused loss pulls those chains in:
    finite, with finite gradients."""
    case = make_case(**{**KL_DDS, "n": 256})
    neg = scan_neg_elbos(case, jod.CAIS)
    want_l, want_g = jax.value_and_grad(lambda tr: jnp.mean(neg(tr)))(case["jparams"]["train"])
    got_l, got_g = torch_value_and_grad(case, tb.kl_bound)
    assert got_l == float(want_l) == float("inf")
    assert all(np.isfinite(g).all() for g in jax.tree_util.tree_leaves(got_g))
    assert_grads_close(got_g, want_g, rel=KL_REL)
    loss, (neg_f, _) = kl_bound_fused(case["params"], 256, case["ctx"], case["setup"],
                                      case["target"], **case["draws"])
    leaves = list(case["params"]["train"]["sn"].parameters())
    grads = torch.autograd.grad(loss, leaves)
    assert bool(torch.isfinite(neg_f).all()) and all(bool(torch.isfinite(g).all()) for g in grads)
    before = params_to_numpy(case["params"]["train"]["sn"])
    res = train(case["setup"], case["params"], case["ctx"], lr=0.001, iters=5, batch_size=256,
                trainable=case["trainable"], nan_check_every=1)
    assert not res.diverged and res.steps_done == 5
    assert bool(torch.isinf(res.losses).all())
    after = params_to_numpy(res.params["train"]["sn"])
    assert not np.allclose(after["state_net"][-1]["w"], before["state_net"][-1]["w"])


# --- the refusals and the CLI -----------------------------------------------

@pytest.mark.parametrize("bad", ["units-16-32", "units-three", "dnf", "underdamped"])
def test_refusals_before_any_launch(bad):
    target = load_target("many_gmm", device="cpu")
    kw = dict(mode="MCD_CAIS_sn", dim=2, nbridges=8, nn_arch="dds")
    if bad == "units-16-32":
        kw["fully_connected_units"] = (16, 32)
    elif bad == "units-three":
        kw["fully_connected_units"] = (16, 16, 16)
    elif bad == "dnf":
        kw["mode"] = "MCD_DNF"
    else:
        kw["mode"] = "MCD_U_a-lp-sn"
    setup = tb.CMCDSetup(**kw)
    assert not supports_fused(setup, target) and not supports_fused_train(setup, target)
    if bad == "dnf":  # DNF trains fused with the geffner nets only
        assert fused_training_path(setup, 64)[0] is kl_bound_fused
        with pytest.raises(NotImplementedError):
            kl_bound_fused({}, 8, None, setup, target)
        return
    if bad == "underdamped":
        with pytest.raises(NotImplementedError):
            kl_bound_fused({}, 8, None, setup, target)
        return
    # The wrappers raise on the net itself, before anything runs.
    sn, _ = build_score_network(2, 0, 8, arch="dds", fully_connected_units=list(
        kw["fully_connected_units"]))
    score = score_for_target(target, "cpu")
    with pytest.raises(NotImplementedError, match="two equal widths"):
        evolve_overdamped_fused(torch.zeros(4, 2), torch.zeros(4), torch.ones(8), 0.1,
                                torch.zeros(2), torch.zeros(2), score, tod.CAIS, dim=2,
                                nbridges=8, sn=sn)
    with pytest.raises(NotImplementedError, match="two equal widths"):
        evolve_kl_bwd(torch.zeros(9, 4, 2), torch.zeros(8, 4, 2), torch.zeros(4),
                      torch.zeros(4, 2), torch.ones(8), 0.1, torch.zeros(2), torch.zeros(2),
                      score, tod.CAIS, dim=2, nbridges=8, sn=sn)


def test_pis_forms_name_their_net_in_the_launch_counts():
    score = score_for_target(load_target("many_gmm", device="cpu"), "cpu")
    case = make_case(arch="dds_grad")
    sn = case["params"]["train"]["sn"]
    assert overdamped.form_key(tod.CAIS, score, sn) == "CAIS/many_gmm/dds_grad"
    assert overdamped.form_key(tod.ULA, score, sn) == "ULA/many_gmm"
    geffner, _ = build_score_network(2, 16, K)
    assert overdamped.form_key(tod.CAIS, score, geffner) == "CAIS/many_gmm"


def test_cli_carries_fully_connected_units_into_the_setup(capsys):
    """--config.nn_arch dds --config.fully_connected_units 16,16 on the CPU:
    the setup and the net take the widths; the fused KL path trains."""
    flags = ("--config.model many_gmm --config.boundmode MCD_CAIS_sn --config.N 64 "
             "--config.nbridges 6 --config.nn_arch dds --config.fully_connected_units 16,16 "
             "--config.init_sigma 8 --config.init_eps 0.1 --config.grad_clipping True "
             "--config.train_eps False --config.train_vi False --config.lr 0.001 "
             "--config.iters 4 --noconfig.pretrain_mfvi --config.n_samples 64 "
             "--config.n_input_dist_seeds 2").split()
    cfg = parse_flags(flags)
    assert cfg.fully_connected_units == [16, 16] and cfg.nn_arch == "dds"
    out = run_experiment(cfg, device="cpu")
    printed = capsys.readouterr().out
    assert "kl_bound_fused, KL reverse sweep" in printed
    sn = out["train"].params["train"]["sn"]
    assert isinstance(sn, PISNet) and sn.units == [16, 16]
    assert sn.state_net[0].weight.shape == (16, 2 + 16)
    assert np.isfinite(out["final_ln_Z"]) and out["train"].steps_done == 4
