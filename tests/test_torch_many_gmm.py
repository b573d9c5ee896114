"""The port's many_gmm target and its kernel-form score against the JAX
package, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmcd_tpu.ops.target_grads import make_many_gmm_grad_t
from cmcd_tpu.targets.gmm import make_many_gmm as j_make_many_gmm
from cmcd_tpu_torch.ops.target_grads import make_many_gmm_score, score_for_target
from cmcd_tpu_torch.targets import load_target
from cmcd_tpu_torch.targets.gmm import make_many_gmm, many_gmm_means

torch.set_num_threads(1)


def _points(seed, n=200, spread=45.0, far=None):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-spread, spread, size=(n, 2)).astype(np.float32)
    if far is not None:
        x = np.concatenate([x, np.asarray(far, np.float32)])
    return x


def test_committed_means_equal_jax_draw():
    want = jax.random.uniform(
        shape=(40, 2), key=jax.random.PRNGKey(0), minval=-1.0, maxval=1.0
    ) * 40.0
    np.testing.assert_array_equal(many_gmm_means().numpy(), np.asarray(want))


def test_log_prob_matches_jax_including_floor():
    far = [[500.0, 500.0], [-300.0, 0.0], [0.0, 200.0]]
    x = _points(0, far=far)
    got = make_many_gmm().log_prob(torch.from_numpy(x)).numpy()
    want = np.asarray(j_make_many_gmm().log_prob(jnp.asarray(x)))
    assert np.all(np.isneginf(got[-3:])) and np.all(np.isneginf(want[-3:]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_log_prob_autograd_grad_matches_jax():
    """Including beyond the floor, where both gradients are exactly 0."""
    x = _points(1, far=[[500.0, 500.0], [-300.0, 0.0]])
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(make_many_gmm().log_prob(xt).sum(), xt)
    jt = j_make_many_gmm()
    want = np.asarray(jax.grad(lambda z: jnp.sum(jt.log_prob(z)))(jnp.asarray(x)))
    assert np.all(got.numpy()[-2:] == 0.0) and np.all(want[-2:] == 0.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_kernel_score_matches_jax_kernel_score_inside_support():
    """The TPU score expands |x - m|^2 into x^2 and x.m terms (logits of
    ~4e3 at |x| = 45, ~3e-4 absolute in f32); the port keeps the
    difference form, so the two agree to ~1e-4 relative."""
    x = _points(2)
    got = make_many_gmm_score()(torch.from_numpy(x)).numpy()
    grad_t = make_many_gmm_grad_t(8)
    z_t = jnp.zeros((8, x.shape[0])).at[:2].set(jnp.asarray(x).T)
    want = np.asarray(grad_t(z_t))[:2].T
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_kernel_score_matches_autograd_score():
    x = torch.from_numpy(_points(3))
    xt = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(make_many_gmm().log_prob(xt).sum(), xt)
    np.testing.assert_allclose(make_many_gmm_score()(x).numpy(), g.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_registry_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_target("banana", device="cpu")
    with pytest.raises(NotImplementedError):
        make_many_gmm(n_mixes=8, loc_scaling=10.0)
    assert score_for_target(load_target("many_gmm", device="cpu")) is not None
