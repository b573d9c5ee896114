"""The port's KL (backprop-through-time) gradient against the JAX package, on
the CPU, under the same base normals and injected noise.

Four layers, each held to the next: the eager kl_bound under torch.autograd
(the oracle) against jax.grad of the scan loss; the score's written-out
Hessian product against float64 autograd; the reverse sweep's plain version
against the Pallas kernel evolve_kl_bwd_pallas in interpret mode on the same
trajectory, noise and cotangents; and the custom VJP kl_bound_fused (plain
versions on a CPU tensor) against the oracle and kl_bound_pallas.

Tolerances as tests/test_pallas_kl.py: loss rtol 1e-4, gradient
|g_t - g_j| < 2e-4 |g_j| + 1e-4 over the flattened tree, and the same per
leaf so that a wrong small leaf (eps, vd) cannot hide behind the net's norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmcd_tpu.integrators import overdamped as jod
from cmcd_tpu.ops.fused import _dim_pad
from cmcd_tpu.ops.fused_train import kl_bound_pallas
from cmcd_tpu.ops.pallas_kl import evolve_kl_bwd_pallas
from cmcd_tpu_torch import bounds as tb
from cmcd_tpu_torch.distributions import std_normal_log_prob
from cmcd_tpu_torch.integrators import overdamped as tod
from cmcd_tpu_torch.ops import kl
from cmcd_tpu_torch.ops.fused_train import (
    KL_FUSED_MODES,
    UD_KL_FUSED_MODES,
    UHA_KL_FUSED_MODES,
    fused_training_path,
    kl_bound_fused,
    supports_fused_train,
    var_bound_fused,
)
from cmcd_tpu_torch.ops.kl import evolve_kl_bwd, evolve_kl_bwd_plain
from cmcd_tpu_torch.ops.overdamped import evolve_overdamped_fused
from cmcd_tpu_torch.ops.target_grads import make_many_gmm_score
from cmcd_tpu_torch.targets import Target, load_target
from cmcd_tpu_torch.utils.convert import grads_to_numpy
from test_torch_vargrad import (
    _jax_forward_with_trajectory,
    _port_rollout_args,
    assert_grads_close,
    scan_neg_elbos,
    torch_value_and_grad,
)
from test_torch_vargrad import make_case as vargrad_case

torch.set_num_threads(1)

K, N, EMB = 5, 96, 16
SCHEDULES = ["", "cos_sq", "linear"]


def make_case(eps_schedule="", grad_clipping=True, n=N, k=K):
    """One MCD_CAIS_sn problem in both packages (test_torch_vargrad.make_case
    at the sizes and scales of tests/test_pallas_kl.py)."""
    return vargrad_case(eps_schedule, grad_clipping, n=n, k=k, mode="MCD_CAIS_sn",
                        eps=0.1, init_sigma=8.0)


def scan_loss(case):
    """The JAX scan KL loss of tests/test_pallas_kl.py as a function of the
    trainable tree."""
    neg_elbos = scan_neg_elbos(case, jod.CAIS)
    return lambda train: jnp.mean(neg_elbos(train))


@pytest.mark.parametrize("grad_clipping", [True, False])
@pytest.mark.parametrize("eps_schedule", SCHEDULES)
def test_eager_kl_bound_grad_matches_jax_scan(eps_schedule, grad_clipping):
    """The eager loss under autograd is the full backprop through time: the
    state chain reaches vd, mgridref_y and the net through every step."""
    case = make_case(eps_schedule, grad_clipping)
    want_l, want_g = jax.value_and_grad(scan_loss(case))(case["jparams"]["train"])
    got_l, got_g = torch_value_and_grad(case, tb.kl_bound)
    np.testing.assert_allclose(got_l, float(want_l), rtol=1e-4)
    assert_grads_close(got_g, want_g, rel=2e-4)


@pytest.mark.parametrize("where", ["modes", "between", "far"])
def test_many_gmm_hvp_matches_float64_autograd(where):
    score = make_many_gmm_score("cpu")
    rng = np.random.default_rng(5)
    means = score.means.double().numpy()
    if where == "modes":
        x = means[rng.integers(0, 40, 64)] + rng.standard_normal((64, 2))
    elif where == "between":  # midpoints of pairs of modes: the softmax is split
        i, j = rng.integers(0, 40, 64), rng.integers(0, 40, 64)
        x = 0.5 * (means[i] + means[j]) + 0.05 * rng.standard_normal((64, 2))
    else:
        x = rng.uniform(-60, 60, (64, 2))
    x = torch.from_numpy(x)
    v = torch.from_numpy(rng.standard_normal((64, 2)))
    _, want = torch.autograd.functional.vjp(score, x, v)
    got = score.hvp(x, v)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9, atol=1e-9)
    # In float32, against the float64 value: the centred sums lose nothing
    # to |d_k|^2 ~ 3e3 between modes.
    got32 = score.hvp(x.float(), v.float()).double()
    scale = float(want.norm(dim=-1).max())
    assert float((got32 - want).abs().max()) < 1e-4 * scale + 1e-4


def _jax_forward(case):
    """JAX's fused rollout in interpret mode under the injected noise:
    (traj_t, noise_t in the kernel's transposed layout, the kernel arguments)."""
    _, _, _, traj_t, args, kw = _jax_forward_with_trajectory(case, jod.CAIS)
    noise_t = jnp.zeros((case["k"], _dim_pad(2), traj_t.shape[2]), jnp.float32).at[
        :, :2, :case["n"]].set(jnp.swapaxes(case["jnoise"], 1, 2))
    return traj_t, noise_t, args, kw


def _port_args(case):
    return _port_rollout_args(case, tod.CAIS)


def _to_jax_layout(case, g):
    """A port gradient dict of the sweep as the JAX kernel's."""
    sn = case["params"]["train"]["sn"]
    for name, p in sn.named_parameters():
        p.grad = g["sn"][name]
    return {"eps": g["eps"].numpy(), "betas": g["betas"].numpy(),
            "vd_mean": g["vd_mean"].numpy(), "vd_logdiag": g["vd_logdiag"].numpy(),
            "sn": grads_to_numpy(sn)}


@pytest.mark.parametrize("eps_schedule,grad_clipping",
                         [("", True), ("cos_sq", True), ("linear", True), ("", False)])
def test_sweep_plain_matches_jax_sweep_kernel(eps_schedule, grad_clipping):
    case = make_case(eps_schedule, grad_clipping)
    traj_t, noise_t, j_args, j_kw = _jax_forward(case)
    cot = case["rng"].standard_normal(N).astype(np.float32)
    g_zfinal = case["rng"].standard_normal((N, 2)).astype(np.float32)
    want, want_z0 = evolve_kl_bwd_pallas(
        traj_t, noise_t, jnp.asarray(cot), jnp.asarray(g_zfinal), *j_args, n_chains=N, **j_kw)
    traj = torch.from_numpy(np.ascontiguousarray(
        np.asarray(traj_t)[:, :2, :N].transpose(0, 2, 1)))
    args, kw = _port_args(case)
    before = evolve_kl_bwd.launches
    got, got_z0 = evolve_kl_bwd(traj, case["draws"]["noise"], torch.from_numpy(cot),
                                torch.from_numpy(g_zfinal), *args, **kw)
    assert evolve_kl_bwd.launches == before  # no kernel on a CPU tensor
    assert_grads_close(_to_jax_layout(case, got), jax.device_get(want), rel=2e-4)
    want_z0 = np.asarray(want_z0)
    assert np.linalg.norm(got_z0.numpy() - want_z0) < 2e-4 * np.linalg.norm(want_z0) + 1e-4
    assert np.linalg.norm(want_z0) > 1.0


def test_sweep_plain_in_float64_agrees_with_float32():
    """The arbiter of two float32 summation orders: the same sweep in
    float64 on the same inputs."""
    case = make_case()
    args, kw = _port_args(case)
    z0 = 8.0 * case["draws"]["base_normals"]
    _, _, traj, noise = evolve_overdamped_fused(
        z0, torch.zeros(N), *args, noise=case["draws"]["noise"], return_trajectory=True,
        return_noise=True, **kw)
    assert noise is case["draws"]["noise"]  # injected noise is handed on as it is
    cot, g_zf = torch.ones(N), torch.zeros(N, 2)
    g32, z32 = evolve_kl_bwd_plain(traj, noise, cot, g_zf, *args, **kw)
    g64, z64 = evolve_kl_bwd_plain(traj.double(), noise.double(), cot, g_zf, *args, **kw)
    assert z64.dtype == torch.float64 and g64["sn"]["emb"].dtype == torch.float64
    flat = lambda g: {**{k: v for k, v in g.items() if k != "sn"}, **g["sn"], "z0": None}
    for name, want in {**flat(g64), "z0": z64}.items():
        got = {**flat(g32), "z0": z32}[name]
        err = float((got.double() - want).norm())
        assert err <= 1e-4 * float(want.norm()) + 1e-5, name


# n = 100: no multiple of the kernels' chain tiles.
@pytest.mark.parametrize("n,eps_schedule,against_jax_fused",
                         [(N, "", True), (100, "cos_sq", True), (N, "linear", False)])
def test_kl_bound_fused_matches_oracle_and_jax_fused(n, eps_schedule, against_jax_fused):
    case = make_case(eps_schedule, n=n)

    def pallas_loss(train):
        return kl_bound_pallas(
            {"train": train, "notrain": case["jparams"]["notrain"]}, case["key"], n,
            case["jctx"], case["jsetup"], case["jt"], block=128, noise=case["jnoise"],
            interpret=True)[0]

    fused = lambda p, n_, c, s, **d: kl_bound_fused(p, n_, c, s, case["target"], **d)
    got_l, got_g = torch_value_and_grad(case, fused)
    oracle_l, oracle_g = torch_value_and_grad(case, tb.kl_bound)
    np.testing.assert_allclose(got_l, oracle_l, rtol=1e-4)
    assert_grads_close(got_g, oracle_g, rel=2e-4)
    if against_jax_fused:
        want_l, want_g = jax.value_and_grad(pallas_loss)(case["jparams"]["train"])
        np.testing.assert_allclose(got_l, float(want_l), rtol=1e-4)
        assert_grads_close(got_g, want_g, rel=2e-4)


def test_kl_bound_fused_carries_the_state_gradient_to_the_draw():
    """Unlike VarGrad, z0 and z_final are in the graph: the loss's gradient
    in the base normals is the oracle's."""
    case = make_case()
    grads = []
    for loss_fn in (lambda *a, **k: kl_bound_fused(*a, case["target"], **k), tb.kl_bound):
        base = case["draws"]["base_normals"].clone().requires_grad_(True)
        loss, (neg, z) = loss_fn(case["params"], N, case["ctx"], case["setup"],
                                 base_normals=base, noise=case["draws"]["noise"])
        assert z.requires_grad and neg.requires_grad
        grads.append(torch.autograd.grad(loss, base)[0].numpy())
    assert np.linalg.norm(grads[0] - grads[1]) < 2e-4 * np.linalg.norm(grads[1]) + 1e-6
    assert np.linalg.norm(grads[1]) > 1e-2


def test_fused_kl_gate_and_mode_checks():
    target = load_target("many_gmm", device="cpu")
    # The overdamped members (the sweep's four forms, DNF's two-net form
    # among them: tests/test_torch_dnf.py); the approximate-refresh
    # underdamped modes and UHA joined them with their own sweeps
    # (tests/test_torch_kl_underdamped.py, tests/test_torch_uha.py).
    assert (KL_FUSED_MODES - UD_KL_FUSED_MODES - UHA_KL_FUSED_MODES
            == {"MCD_CAIS_sn", "MCD_ULA_sn", "MCD_ULA", "MCD_DNF"})
    assert "MCD_DNF" in KL_FUSED_MODES
    assert supports_fused_train(
        tb.CMCDSetup(mode="MCD_CAIS_sn", dim=2, nbridges=256, emb_dim=130), target)
    assert kl.kernel_fits(132, 80, 2) and not kl.kernel_fits(148, 80, 2)
    assert not supports_fused_train(
        tb.CMCDSetup(mode="MCD_CAIS_sn", dim=2, nbridges=8, emb_dim=160), target)
    case = make_case()
    with pytest.raises(NotImplementedError, match="MCD_CAIS_var_sn"):
        var_bound_fused(case["params"], N, case["ctx"], case["setup"], case["target"])
    var_setup = tb.CMCDSetup(mode="MCD_CAIS_var_sn", dim=2, nbridges=K, emb_dim=EMB)
    with pytest.raises(NotImplementedError, match="MCD_CAIS_sn"):
        kl_bound_fused(case["params"], N, case["ctx"], var_setup, case["target"])


@pytest.mark.parametrize("mode", ["MCD_U_e-lp", "MCD_DNF"])
def test_fused_training_path_refuses_a_mode_without_a_fused_loss(mode):
    """DNF and the exact refresh (MCD_U_e-lp) each have a fused loss since
    their sweeps were ported, so the path names kl_bound_fused. What stays
    refused before anything runs: DNF with a PIS net (the JAX package fuses
    none), and for the exact refresh a target whose score no underdamped
    kernel inlines (the standard normal at dim 10)."""
    setup = tb.CMCDSetup(mode=mode, dim=2, nbridges=8, emb_dim=16)
    if mode == "MCD_DNF":
        assert fused_training_path(setup, 256)[0] is kl_bound_fused
        target = load_target("many_gmm", device="cpu")
        assert supports_fused_train(setup, target)
        pis = tb.CMCDSetup(mode=mode, dim=2, nbridges=8, nn_arch="dds",
                           fully_connected_units=(16, 16))
        assert not supports_fused_train(pis, target)
        with pytest.raises(NotImplementedError, match=mode):
            kl_bound_fused({}, 8, None, pis, target)
        return
    assert fused_training_path(setup, 256)[0] is kl_bound_fused
    normal = Target("std_normal", 10, std_normal_log_prob)
    setup = tb.CMCDSetup(mode=mode, dim=10, nbridges=8, emb_dim=16)
    assert not supports_fused_train(setup, normal)
    with pytest.raises(NotImplementedError, match=mode):
        kl_bound_fused({}, 8, None, setup, normal)


@pytest.mark.parametrize("bad", ["spec", "score", "shape", "noise", "schedule"])
def test_sweep_wrapper_refuses_what_the_kernel_does_not_take(bad):
    case = make_case()
    (betas, eps, mean, logdiag, score, spec), kw = _port_args(case)
    traj, noise = torch.zeros(K + 1, N, 2), torch.zeros(K, N, 2)
    cot, g_zf = torch.zeros(N), torch.zeros(N, 2)
    if bad == "spec":
        spec = tod.CAIS_VAR  # stops the state gradient: the VarGrad kernels' case
    elif bad == "score":
        score = lambda z: -z
    elif bad == "shape":
        traj = torch.zeros(K, N, 2)
    elif bad == "noise":
        noise = torch.zeros(K + 1, N, 2)
    elif bad == "schedule":
        kw["eps_schedule"] = "exp"
    with pytest.raises((NotImplementedError, ValueError)):
        evolve_kl_bwd(traj, noise, cot, g_zf, betas, eps, mean, logdiag, score, spec, **kw)
