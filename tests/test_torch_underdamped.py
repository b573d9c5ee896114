"""The port's underdamped family against the JAX package, on the CPU, under
the same base normals and injected noise (K + 1 rows: the initial momentum,
then one refresh draw per step), on many_gmm, the 3-mode gmm and Neal's
funnel (dim 10; CAIS_UHA's with its clip at 1e2 engaged).

Three layers, each held to the next: the eager stepper
(integrators/underdamped.py) against JAX's scan stepper for all seven specs;
the geffner net on [z, rho] through the converter against JAX's apply; the
fused rollout's plain version (ops/underdamped.py) against the Pallas kernel
evolve_underdamped_pallas in interpret mode, final state, log-weight and the
three stores. Then the evaluation entry compute_elbos_fused for an
underdamped mode against the eager compute_elbos.

Tolerances: the eager stepper to 1e-5 of the largest value (z, w); the
plain rollout as tests/test_pallas_kl.py:228 (w atol 5e-4, rtol 1e-4; z and
the stored paths atol 2e-4, rtol 1e-4), the noise stack exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cmcd_tpu
from cmcd_tpu import bounds as jb
from cmcd_tpu.integrators import underdamped as jud
from cmcd_tpu.networks.geffner import build_geffner_network
from cmcd_tpu.ops import target_grads as jtg
from cmcd_tpu.ops.fused import _dim_pad
from cmcd_tpu.ops.pallas_underdamped import evolve_underdamped_pallas, pack_geffner_ud_t
from cmcd_tpu.schedules import betas_from_grid as j_betas_from_grid
from cmcd_tpu_torch import bounds as tb
from cmcd_tpu_torch.integrators import UNDERDAMPED, mode_sn_rho_dim
from cmcd_tpu_torch.integrators import underdamped as tud
from cmcd_tpu_torch.ops.fused import compute_elbos_fused, supports_fused
from cmcd_tpu_torch.ops.target_grads import score_for_target
from cmcd_tpu_torch.ops.underdamped import (
    evolve_underdamped_fused,
    evolve_underdamped_fused_plain,
    uses_net,
)
from cmcd_tpu_torch.schedules import betas_from_grid
from cmcd_tpu_torch.targets import load_target
from cmcd_tpu_torch.utils.convert import geffner_from_jax, params_from_jax, params_to_numpy

torch.set_num_threads(1)

K, N, EMB = 4, 96, 16
MODES = list(UNDERDAMPED)
TARGETS = ("many_gmm", "gmm", "funnel")
# The variational spread per target: many_gmm's modes lie 40 apart; on the
# funnel CAIS_UHA starts wider, so that v < -4.6 on many chains and its
# target score clip at 1e2 engages.
SIGMA = {"many_gmm": 8.0, "gmm": 3.0, "funnel": 1.0, "funnel CAIS_UHA": 3.0}


def case_sigma(mode, target):
    return SIGMA[f"{target} CAIS_UHA" if (target, mode) == ("funnel", "MCD_CAIS_UHA_sn")
                 else target]


def make_ud_case(mode, n=N, k=K, eps=0.05, gamma=5.0, eta=0.5, init_sigma=None,
                 target="many_gmm"):
    """One underdamped problem in both packages (the sizes and scales of
    tests/test_pallas_kl.py:251-314, gamma eps = 0.25): every leaf
    trainable, factor_sn 0.3 and a random head where there is a net,
    non-uniform beta knots, an off-centre variational mean; init_sigma
    default case_sigma(mode, target)."""
    jt = cmcd_tpu.load_target(target)
    dim = jt.dim
    init_sigma = case_sigma(mode, target) if init_sigma is None else init_sigma
    kw = dict(mode=mode, dim=dim, nbridges=k, emb_dim=EMB)
    jsetup = jb.CMCDSetup(**kw)
    params, jctx = jb.initialize(jsetup, jt.log_prob, eps=eps, gamma=gamma, eta=eta,
                                 init_sigma=init_sigma,
                                 trainable=jb.default_trainable(mode))
    if "sn" in params["train"]:
        sn = params["train"]["sn"]
        sn["factor_sn"] = jnp.asarray(0.3)
        sn["head"]["w"] = 0.05 * jax.random.normal(jax.random.PRNGKey(9), sn["head"]["w"].shape)
    params["train"]["mgridref_y"] = jax.random.uniform(
        jax.random.PRNGKey(4), params["train"]["mgridref_y"].shape, minval=0.5, maxval=1.5)
    params["train"]["vd"]["mean"] = jnp.asarray([0.5 * (-1) ** d for d in range(dim)],
                                                jnp.float32)
    key = jax.random.PRNGKey(0)
    base = np.array(jax.random.normal(jax.random.split(key)[0], (n, dim)))
    rng = np.random.default_rng(2)
    noise = rng.standard_normal((k + 1, n, dim)).astype(np.float32)
    target = load_target(target, device="cpu")
    tsetup = tb.CMCDSetup(**kw)
    _, tctx = tb.initialize(tsetup, target.log_prob, device="cpu")
    return {
        "mode": mode, "spec": UNDERDAMPED[mode], "jspec": jb.integrators._UNDERDAMPED[mode],
        "jt": jt, "jsetup": jsetup, "jparams": params, "jctx": jctx, "key": key,
        "jnoise": jnp.asarray(noise), "n": n, "k": k, "rng": rng, "dim": dim,
        "target": target, "setup": tsetup, "ctx": tctx,
        "params": params_from_jax(jax.device_get(params), device="cpu"),
        "draws": {"base_normals": torch.from_numpy(base), "noise": torch.from_numpy(noise)},
    }


def jax_rollout_args(case):
    """z0, betas and the rest of the Pallas kernel's arguments, from JAX's
    merged parameters: (z0, args, kw)."""
    p = jb.merged_params(case["jparams"])
    betas = j_betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])
    z0 = p["vd"]["mean"] + jnp.exp(p["vd"]["logdiag"]) * jnp.asarray(
        case["draws"]["base_normals"].numpy())
    dim = case["dim"]
    weights = meta = None
    if uses_net(case["spec"]):
        weights, meta = pack_geffner_ud_t(p["sn"], dim, _dim_pad(dim),
                                          case["spec"].bwd_sn == "full")
    args = (betas, p["eps"], p["gamma"], p["eta"], p["vd"]["mean"], p["vd"]["logdiag"],
            jtg.grad_t_for_target(case["jt"], _dim_pad(dim)), case["jspec"])
    kw = dict(dim=dim, nbridges=case["k"], sn_weights=weights, sn_meta=meta)
    return z0, args, kw


def port_rollout_args(case):
    """z0 and the port rollout's arguments after z0 and w0: (z0, args, kw)."""
    p = tb.merged_params(case["params"])
    betas = betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"]).detach()
    z0 = (p["vd"]["mean"] + torch.exp(p["vd"]["logdiag"])
          * case["draws"]["base_normals"]).detach()
    args = (betas, p["eps"].detach(), p["gamma"].detach(), p["eta"].detach(),
            p["vd"]["mean"].detach(), p["vd"]["logdiag"].detach(),
            score_for_target(case["target"]), case["spec"])
    return z0, args, dict(dim=case["dim"], nbridges=case["k"], sn=p.get("sn"))


def from_t(x_t, n, dim=2):
    """A (rows, dim_pad, n_pad) stack of the TPU kernel as (rows, n, dim)."""
    return np.asarray(x_t)[:, :dim, :n].transpose(0, 2, 1)


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("mode", MODES)
def test_eager_stepper_matches_jax_scan(mode, target):
    case = make_ud_case(mode, target=target)
    jp = jb.merged_params(case["jparams"])
    jbetas = j_betas_from_grid(jp["mgridref_y"], jp["gridref_x"], jp["target_x"])
    z0 = case_sigma(mode, target) * case["draws"]["base_normals"]
    want_z, want_w, _ = jud.evolve_underdamped(
        case["key"], jnp.asarray(z0.numpy()), jbetas, jp, case["jctx"], case["jspec"],
        noise=case["jnoise"])
    tp = tb.merged_params(case["params"])
    tbetas = betas_from_grid(tp["mgridref_y"], tp["gridref_x"], tp["target_x"])
    got_z, got_w, _ = tud.evolve_underdamped(z0, tbetas, tp, case["ctx"], case["spec"],
                                             noise=case["draws"]["noise"])
    want_z, want_w = np.asarray(want_z), np.asarray(want_w)
    np.testing.assert_allclose(got_z.detach().numpy(), want_z, rtol=1e-5,
                               atol=1e-5 * np.abs(want_z).max())
    np.testing.assert_allclose(got_w.detach().numpy(), want_w, rtol=1e-5,
                               atol=1e-5 * np.abs(want_w).max())


@pytest.mark.parametrize("rho_dim", [0, 2])
def test_geffner_net_on_z_and_rho_matches_jax_apply(rho_dim):
    init, apply = build_geffner_network(2, EMB, K, rho_dim=rho_dim)
    sn = init(jax.random.PRNGKey(3))
    sn = {**sn, "factor_sn": jnp.asarray(0.7)}
    net = geffner_from_jax(jax.device_get(sn), device="cpu")
    assert (net.rho_dim, net.in_dim) == (rho_dim, 2 + rho_dim + EMB)
    x = np.random.default_rng(0).standard_normal((64, 2 + rho_dim)).astype(np.float32)
    for i in (0, K - 1, K):  # K: clamped to the last row
        want = np.asarray(apply(sn, jnp.asarray(x), i))
        got = net(torch.from_numpy(x), i).detach().numpy()
        assert got.shape == (64, 2)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    back = params_to_numpy({"sn": net})["sn"]
    np.testing.assert_array_equal(back["layers"][0]["w"], np.asarray(sn["layers"][0]["w"]))
    assert mode_sn_rho_dim("MCD_U_a-lp-sn", 2) == 2 and mode_sn_rho_dim("MCD_U_a-lp-sna", 2) == 0


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("mode", MODES)
def test_rollout_plain_matches_pallas_kernel(mode, target):
    case = make_ud_case(mode, target=target)
    dim = case["dim"]
    z0_j, j_args, j_kw = jax_rollout_args(case)
    z_j, w_j, zt_j, rt_j, nt_j = evolve_underdamped_pallas(
        z0_j, *j_args, **j_kw, noise=case["jnoise"], block=128, interpret=True,
        return_state_t=True)
    z0, args, kw = port_rollout_args(case)
    before = evolve_underdamped_fused.launches
    z, w, ztraj, rtraj, draws = evolve_underdamped_fused(
        z0, torch.zeros(N), *args, **kw, noise=case["draws"]["noise"], return_state=True)
    assert evolve_underdamped_fused.launches == before  # no kernel on a CPU tensor
    assert draws is case["draws"]["noise"]  # injected noise is handed on as it is
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=5e-4, rtol=1e-4)
    np.testing.assert_allclose(ztraj.numpy(), from_t(zt_j, N, dim), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(rtraj.numpy(), from_t(rt_j, N, dim), atol=2e-4, rtol=1e-4)
    np.testing.assert_array_equal(draws.numpy(), from_t(nt_j, N, dim))
    assert torch.equal(ztraj[0], z0) and torch.equal(ztraj[K], z)
    assert torch.equal(rtraj[0], draws[0])


def test_rollout_plain_draws_its_own_noise_and_stores_it():
    """Without injected noise the plain version draws from its generator and
    hands the draws on; injected again they give the same rollout."""
    case = make_ud_case("MCD_U_a-lp-sn")
    z0, args, kw = port_rollout_args(case)
    w0 = torch.zeros(N)
    z, w, ztraj, rtraj, draws = evolve_underdamped_fused_plain(
        z0, w0, *args, **kw, seed=5, return_state=True)
    assert draws.shape == (K + 1, N, 2)
    z2, w2 = evolve_underdamped_fused_plain(z0, w0, *args, **kw, noise=draws)
    assert torch.equal(z, z2) and torch.equal(w, w2)


def test_rollout_wrapper_checks_the_net_against_the_spec():
    case = make_ud_case("MCD_U_a-lp-sna")  # a net on z
    z0, args, kw = port_rollout_args(case)
    full = (*args[:-1], UNDERDAMPED["MCD_U_a-lp-sn"])  # a spec whose net sees [z, rho]
    with pytest.raises(ValueError, match="input columns"):
        evolve_underdamped_fused(z0, torch.zeros(N), *full, **kw)
    with pytest.raises(ValueError, match="noise"):
        evolve_underdamped_fused(z0, torch.zeros(N), *args, **kw,
                                 noise=case["draws"]["noise"][1:])


@pytest.mark.parametrize("mode", ["MCD_U_a-lp-sn", "MCD_U_e-lp", "MCD_CAIS_UHA_sn"])
def test_compute_elbos_fused_matches_eager_compute_elbos(mode):
    case = make_ud_case(mode)
    assert supports_fused(case["setup"], case["target"])
    got_neg, got_z = compute_elbos_fused(case["params"], N, case["setup"], case["target"],
                                         **case["draws"])
    want_neg, want_z = tb.compute_elbos(case["params"], N, case["ctx"], case["setup"],
                                        **case["draws"])
    np.testing.assert_allclose(got_z.numpy(), want_z.detach().numpy(), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(got_neg.numpy(), want_neg.detach().numpy(), atol=5e-4, rtol=1e-4)


def test_supports_fused_covers_the_underdamped_family_at_full_width():
    """Every spec on the three targets of the kernels at their widths (the
    funnel's recipe emb 48), no other net."""
    for name, dim, embs in (("many_gmm", 2, (16, 130)), ("gmm", 2, (16, 20)),
                            ("funnel", 10, (16, 48))):
        target = load_target(name, device="cpu")
        for mode in MODES:
            for emb in embs:
                setup = tb.CMCDSetup(mode=mode, dim=dim, nbridges=256, emb_dim=emb)
                assert supports_fused(setup, target), (name, mode, emb)
    assert not supports_fused(tb.CMCDSetup(mode="MCD_U_a-lp-sn", dim=2, nbridges=8,
                                           emb_dim=16, nn_arch="dds"),
                              load_target("many_gmm", device="cpu"))
