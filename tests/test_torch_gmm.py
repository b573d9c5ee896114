"""The 3-mode gmm target and its kernel-form score against the JAX package,
on the CPU: the log-density (ln Z = 0, the symmetrised mixture), the
6-branch score of the UHA kernels (ops/target_grads.GMMScore) against JAX's
make_gmm_grad_t and against autograd of the eager log-density, its
hand-written Hessian product against float64 autograd, and the registry's
dispatch ("many_gmm" is matched before "gmm", as in the JAX package).

Tolerances: the log-density and the score to f32 (1e-5 relative); the
Hessian product, whose constants are float32, to 1e-5 of its norm; the
constants to 1e-6 relative (float32 of float64 values); the VarGrad loss
rtol 1e-4 and its gradient 1e-4 |g| + 1e-4 (tests/test_pallas_vargrad.py).
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
from cmcd_tpu.ops.target_grads import make_gmm_grad_t
from cmcd_tpu.schedules import betas_from_grid as j_betas_from_grid
from cmcd_tpu.targets.gmm import _COVS, _MEANS
from cmcd_tpu_torch.ops.fused_train import var_bound_fused
from cmcd_tpu_torch.ops.target_grads import (
    TARGETS,
    GMMScore,
    ManyGMMScore,
    kernel_target,
    score_for_target,
    target_floats,
)
from cmcd_tpu_torch.targets import load_target
from test_torch_ula import make_case, torch_value_and_grad
from test_torch_vargrad import assert_grads_close

torch.set_num_threads(1)


def _points(seed, n=512, scale=3.0):
    """Points over the three modes and between them (both branches)."""
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((n, 2)) + rng.uniform(-1, 2, (n, 2))).astype(np.float32)


def test_log_prob_matches_jax_and_integrates_to_one():
    x = _points(0)
    got = load_target("gmm", device="cpu").log_prob(torch.from_numpy(x)).numpy()
    want = np.asarray(cmcd_tpu.load_target("gmm").log_prob(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # ln Z = 0: a Riemann sum over a box that holds the mass.
    g = np.linspace(-9.0, 9.0, 721, dtype=np.float64)
    xx, yy = np.meshgrid(g, g)
    grid = torch.from_numpy(np.stack([xx.ravel(), yy.ravel()], -1))
    lp = load_target("gmm", device="cpu").log_prob(grid)
    mass = float(torch.exp(lp).sum()) * (g[1] - g[0]) ** 2
    assert abs(mass - 1.0) < 1e-3


def test_kernel_score_matches_jax_kernel_score_and_autograd():
    x = _points(1)
    score = score_for_target(load_target("gmm", device="cpu"))
    assert isinstance(score, GMMScore) and score.kernel_name == "gmm"
    got = score(torch.from_numpy(x)).numpy()
    z_t = jnp.zeros((8, x.shape[0])).at[:2].set(jnp.asarray(x).T)
    want = np.asarray(make_gmm_grad_t(8)(z_t))[:2].T
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    xt = torch.from_numpy(x).requires_grad_(True)
    (g,) = torch.autograd.grad(load_target("gmm", device="cpu").log_prob(xt).sum(), xt)
    np.testing.assert_allclose(got, g.numpy(), rtol=1e-4, atol=1e-4)
    jg = np.asarray(jax.grad(lambda z: cmcd_tpu.load_target("gmm").log_prob(z).sum())(
        jnp.asarray(x)))
    np.testing.assert_allclose(got, jg, rtol=1e-4, atol=1e-4)


def test_hvp_matches_float64_autograd_in_the_input_dtype():
    """The sweep's Hessian product, in float64 as the arbiter runs it."""
    x = torch.from_numpy(_points(2)).double()
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(x.shape))
    score = score_for_target(load_target("gmm", device="cpu"))
    xt = x.clone().requires_grad_(True)
    lp = load_target("gmm", device="cpu").log_prob(xt)
    (g,) = torch.autograd.grad(lp.sum(), xt, create_graph=True)
    (hv,) = torch.autograd.grad((g * v).sum(), xt)
    g = g.detach()
    got = score.hvp(x, v)
    assert got.dtype == torch.float64 and score(x).dtype == torch.float64
    assert float((got - hv).norm()) <= 1e-5 * float(hv.norm())
    assert float((score(x) - g).norm()) <= 1e-5 * float(g.norm())


def test_registry_matches_many_gmm_before_gmm():
    assert load_target("gmm", device="cpu").name == "gmm"
    assert load_target("many_gmm", device="cpu").name == "many_gmm"
    assert isinstance(score_for_target(load_target("many_gmm", device="cpu")), ManyGMMScore)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_target("banana", device="cpu")


def test_target_floats_match_the_jax_constants():
    """The kernels' 18 gmm constants: the means, the precisions' (p11, p12,
    p22) and the log-normalisers, as JAX's make_gmm_grad_t forms them from
    the target's means and covariances."""
    score = score_for_target(load_target("gmm", device="cpu"))
    got = target_floats(score).numpy()
    precs = np.linalg.inv(np.asarray(_COVS, np.float64))
    chols = np.linalg.cholesky(np.asarray(_COVS, np.float64))
    log_norm = -np.log(2 * np.pi) - np.sum(np.log(np.diagonal(chols, axis1=-2, axis2=-1)), -1)
    want = np.concatenate([np.asarray(_MEANS, np.float64).ravel(),
                           np.stack([precs[:, 0, 0], precs[:, 0, 1], precs[:, 1, 1]], -1).ravel(),
                           log_norm])
    assert got.dtype == np.float32 and got.shape == (18,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    code, tpar, inv_var = kernel_target(score, "cpu")
    assert (code, inv_var) == (TARGETS["gmm"], 0.0) and torch.equal(tpar, target_floats(score))
    many = score_for_target(load_target("many_gmm", device="cpu"))
    code, tpar, inv_var = kernel_target(many, "cpu")
    assert code == TARGETS["many_gmm"] and tpar.shape == (80,) and inv_var == many.inv_var
    assert torch.equal(tpar.view(40, 2), many.means)


def jax_var_loss(case):
    """JAX's scan VarGrad loss (the clipped variance of the negative ELBOs)
    under the case's draws, as a function of the trainable tree."""
    def loss(train):
        p = jb.merged_params({"train": train, "notrain": case["jparams"]["notrain"]})
        z = p["vd"]["mean"] + jnp.exp(p["vd"]["logdiag"]) * case["jbase"]
        w = -j_log_prob(p["vd"], z)
        betas = j_betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])
        z, wd, _ = jod.evolve_overdamped(case["key"], z, betas, p, case["jctx"], jod.CAIS_VAR,
                                         noise=case["jnoise"])
        neg = -(w + wd + case["jctx"].target_log_prob(z))
        return jnp.clip(jnp.var(neg, ddof=0), -1e7, 1e7)

    return loss


@pytest.mark.parametrize("backward", ["replay", "reroll"])
def test_var_bound_fused_on_gmm_matches_jax_scan(backward):
    """MCD_CAIS_var_sn on the 3-mode gmm through the fused VarGrad loss (the
    rollout's and both backward kernels' gmm forms, plain versions on the
    CPU) against jax.grad of the scan loss."""
    case = make_case("gmm", "MCD_CAIS_var_sn", eps=0.2)
    fused = lambda p, n_, c, s, **d: var_bound_fused(p, n_, c, s, case["target"],
                                                     backward=backward, **d)
    got_l, got_g = torch_value_and_grad(case, fused)
    want_l, want_g = jax.value_and_grad(jax_var_loss(case))(case["jparams"]["train"])
    np.testing.assert_allclose(got_l, float(want_l), rtol=1e-4)
    assert_grads_close(got_g, want_g, rel=1e-4)
