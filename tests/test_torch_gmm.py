"""The 3-mode gmm target and its kernel-form score against the JAX package,
on the CPU: the log-density (ln Z = 0, the symmetrised mixture), the
6-branch score of the UHA kernels (ops/target_grads.GMMScore) against JAX's
make_gmm_grad_t and against autograd of the eager log-density, its
hand-written Hessian product against float64 autograd, and the registry's
dispatch ("many_gmm" is matched before "gmm", as in the JAX package).

Tolerances: the log-density and the score to f32 (1e-5 relative); the
Hessian product, whose constants are float32, to 1e-5 of its norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cmcd_tpu
from cmcd_tpu.ops.target_grads import make_gmm_grad_t
from cmcd_tpu_torch.ops.target_grads import GMMScore, ManyGMMScore, score_for_target
from cmcd_tpu_torch.targets import load_target

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
        load_target("funnel", device="cpu")
