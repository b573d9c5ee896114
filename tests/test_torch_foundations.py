"""The port's foundations against the JAX package, on the CPU.

Distributions, the beta grid (jnp.interp semantics), the eps schedules and
make_grad_u's clip placement; inputs from a numpy seed fed to both packages.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmcd_tpu import distributions as jd
from cmcd_tpu import schedules as js
from cmcd_tpu.integrators import overdamped as jod
from cmcd_tpu.integrators.base import IntegratorContext as JCtx
from cmcd_tpu.integrators.base import make_grad_u as j_make_grad_u
from cmcd_tpu.targets.gmm import make_many_gmm as j_make_many_gmm
from cmcd_tpu_torch import distributions as td
from cmcd_tpu_torch import schedules as ts
from cmcd_tpu_torch.integrators import overdamped as tod
from cmcd_tpu_torch.integrators.base import IntegratorContext as TCtx
from cmcd_tpu_torch.integrators.base import make_grad_u as t_make_grad_u
from cmcd_tpu_torch.targets.gmm import make_many_gmm as t_make_many_gmm

torch.set_num_threads(1)


def _vd(rng, dim=3):
    mean = rng.normal(size=dim).astype(np.float32)
    logdiag = rng.normal(scale=0.5, size=dim).astype(np.float32)
    return (
        {"mean": jnp.asarray(mean), "logdiag": jnp.asarray(logdiag)},
        {"mean": torch.from_numpy(mean), "logdiag": torch.from_numpy(logdiag)},
    )


def test_diag_gaussian_log_prob_grad_and_sample():
    rng = np.random.default_rng(0)
    jvd, tvd = _vd(rng)
    z = rng.normal(scale=2.0, size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        td.diag_gaussian_log_prob(tvd, torch.from_numpy(z)).numpy(),
        np.asarray(jd.diag_gaussian_log_prob(jvd, jnp.asarray(z))),
        rtol=1e-6, atol=1e-5,
    )
    np.testing.assert_allclose(
        td.diag_gaussian_grad_log_prob(tvd, torch.from_numpy(z)).numpy(),
        np.asarray(jd.diag_gaussian_grad_log_prob(jvd, jnp.asarray(z))),
        rtol=1e-6, atol=1e-6,
    )
    # The reparameterised sample, given JAX's base normals.
    key = jax.random.PRNGKey(3)
    base = np.array(jax.random.normal(key, (64, 3)))
    np.testing.assert_allclose(
        td.diag_gaussian_sample(tvd, 64, base_normals=torch.from_numpy(base)).numpy(),
        np.asarray(jd.diag_gaussian_sample(key, jvd, 64)),
        rtol=1e-6, atol=1e-6,
    )
    init = td.diag_gaussian_init(2, 15.0)
    jinit = jd.diag_gaussian_init(2, 15.0)
    np.testing.assert_allclose(init["logdiag"].numpy(), np.asarray(jinit["logdiag"]), rtol=1e-7)


def test_kernel_log_prob():
    rng = np.random.default_rng(1)
    x, mean = (rng.normal(size=(32, 2)).astype(np.float32) for _ in range(2))
    got = td.kernel_log_prob(torch.from_numpy(x), torch.from_numpy(mean), 0.7)
    want = jd.kernel_log_prob(jnp.asarray(x), jnp.asarray(mean), 0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("knots", ["uniform", "random"])
@pytest.mark.parametrize("nbridges", [1, 5, 64])
def test_betas_from_grid_matches_jnp_interp(knots, nbridges):
    rng = np.random.default_rng(nbridges)
    mg = None
    if knots == "random":
        mg = rng.uniform(0.1, 2.0, size=min(32, nbridges) + 1).astype(np.float32)
    jmg, jgx, jtx = js.make_beta_grid_params(nbridges, 32, None if mg is None else jnp.asarray(mg))
    tmg, tgx, ttx = ts.make_beta_grid_params(nbridges, 32, None if mg is None else torch.from_numpy(mg))
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), rtol=0, atol=1e-7)
    np.testing.assert_allclose(ttx.numpy(), np.asarray(jtx), rtol=0, atol=1e-7)
    np.testing.assert_allclose(
        ts.betas_from_grid(tmg, tgx, ttx).numpy(),
        np.asarray(js.betas_from_grid(jmg, jgx, jtx)),
        rtol=1e-6, atol=1e-7,
    )


def test_interp_endpoints_and_knots():
    xp = np.array([0.0, 0.25, 0.5, 0.5, 1.0], np.float32)  # a repeated knot
    fp = np.array([0.0, 0.1, 0.3, 0.6, 1.0], np.float32)
    x = np.array([-1.0, 0.0, 0.1, 0.25, 0.5, 0.75, 1.0, 2.0], np.float32)
    np.testing.assert_allclose(
        ts.interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp)).numpy(),
        np.asarray(jnp.interp(x, xp, fp)),
        rtol=1e-6, atol=1e-7,
    )


@pytest.mark.parametrize("schedule", ["", "linear", "cos_sq"])
def test_eps_schedules(schedule):
    k = 16
    got = [float(ts.eps_at_step(torch.tensor(0.3), i, k, schedule)) for i in range(k)]
    want = [float(js.eps_at_step(jnp.float32(0.3), i, k, schedule)) for i in range(k)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("mode", ["CAIS", "CAIS_VAR"])
def test_make_grad_u_clip_placement(mode):
    """Far from the modes and with a narrow q, both scores exceed the clip
    values, so the placement (target vs q, 1e3 vs 1e2) decides the result."""
    jspec, tspec = getattr(jod, mode), getattr(tod, mode)
    rng = np.random.default_rng(2)
    z = rng.uniform(-300.0, 300.0, size=(128, 2)).astype(np.float32)
    vd_mean = np.zeros(2, np.float32)
    vd_logdiag = np.full(2, math.log(0.5), np.float32)  # grad q = -4 z
    jt, tt = j_make_many_gmm(), t_make_many_gmm()
    jgu = j_make_grad_u(JCtx(jt.log_prob, 4, 2), {"mean": jnp.asarray(vd_mean),
                        "logdiag": jnp.asarray(vd_logdiag)}, jspec.clip_target, jspec.clip_vd)
    tgu = t_make_grad_u(TCtx(tt.log_prob, 4, 2), {"mean": torch.from_numpy(vd_mean),
                        "logdiag": torch.from_numpy(vd_logdiag)}, tspec.clip_target, tspec.clip_vd)
    # Component log-densities reach -1e4 out here, where f32 keeps ~1e-3
    # absolute, so the responsibilities agree to ~1e-4 relative.
    for beta in (0.0, 0.3, 1.0):
        want = np.asarray(jgu(jnp.asarray(z), beta))
        got = tgu(torch.from_numpy(z), beta).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    # The q score (|.| up to 1200) is clipped at 1e2 for CAIS_VAR only.
    q_only = np.abs(tgu(torch.from_numpy(z), 0.0).numpy()).max()
    assert q_only == pytest.approx(100.0) if mode == "CAIS_VAR" else q_only > 1000.0
