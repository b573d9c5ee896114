"""The port's overdamped rollouts against the JAX package under the same
injected noise, on the CPU.

Port side: the eager integrator (integrators/overdamped.evolve_overdamped)
and the fused wrapper, which on a CPU tensor runs the kernel's plain twin.
JAX side: the scan integrator and the Pallas kernel in interpret mode, as
tests/test_pallas.py runs it. Tolerances as tests/test_pallas.py.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cmcd_tpu
from cmcd_tpu.integrators import overdamped as jod
from cmcd_tpu.integrators.base import IntegratorContext as JCtx
from cmcd_tpu.networks.geffner import build_geffner_network
from cmcd_tpu.ops import target_grads as jtg
from cmcd_tpu.ops.pallas_overdamped import evolve_overdamped_pallas, pack_geffner_t
from cmcd_tpu.schedules import betas_from_grid, make_beta_grid_params
from cmcd_tpu_torch.integrators import overdamped as tod
from cmcd_tpu_torch.integrators.base import IntegratorContext as TCtx
from cmcd_tpu_torch.ops.overdamped import evolve_overdamped_fused
from cmcd_tpu_torch.ops.target_grads import make_many_gmm_score
from cmcd_tpu_torch.targets import load_target
from cmcd_tpu_torch.utils.convert import geffner_from_jax

torch.set_num_threads(1)

K, N, EMB = 6, 128, 16
Z_TOL = dict(atol=2e-4, rtol=1e-4)
W_TOL = dict(atol=5e-4, rtol=1e-4)


def _case(eps_schedule):
    jt = cmcd_tpu.load_target("many_gmm")
    init_sn, apply_sn = build_geffner_network(2, EMB, K)
    sn = {**init_sn(jax.random.PRNGKey(1)), "factor_sn": jnp.asarray(0.3)}
    vd = {"mean": jnp.array([0.5, -0.5]), "logdiag": jnp.ones(2) * jnp.log(3.0)}
    params = {"vd": vd, "eps": jnp.asarray(0.1), "sn": sn}
    mg = jax.random.uniform(jax.random.PRNGKey(5), (K + 1,), minval=0.5, maxval=1.5)
    betas = betas_from_grid(*make_beta_grid_params(K, mgridref_y=mg))
    ctx = JCtx(target_log_prob=jt.log_prob, nbridges=K, dim=2, apply_sn=apply_sn,
               eps_schedule=eps_schedule, grad_clipping=True)
    rng = np.random.default_rng(0)
    z0 = (3.0 * rng.standard_normal((N, 2))).astype(np.float32)
    noise = rng.standard_normal((K, N, 2)).astype(np.float32)
    return jt, params, betas, ctx, z0, noise


@pytest.fixture(scope="module", params=[
    ("CAIS_VAR", ""), ("CAIS_VAR", "cos_sq"), ("CAIS", ""), ("CAIS", "linear"),
])
def case(request):
    """One problem per (spec, eps schedule), with the JAX scan and Pallas
    (interpret) results computed once."""
    spec_name, schedule = request.param
    jt, params, betas, ctx, z0, noise = _case(schedule)
    jspec = getattr(jod, spec_name)
    z_scan, w_scan, _ = jod.evolve_overdamped(
        jax.random.PRNGKey(0), jnp.asarray(z0), betas, params, ctx, jspec,
        noise=jnp.asarray(noise),
    )
    weights, meta = pack_geffner_t(params["sn"], 2, 8)
    z_pal, w_pal = evolve_overdamped_pallas(
        jnp.asarray(z0), jnp.zeros(N), betas, params["eps"], params["vd"]["mean"],
        params["vd"]["logdiag"], jtg.grad_t_for_target(jt, 8), jspec, dim=2,
        nbridges=K, sn_weights=weights, sn_meta=meta, eps_schedule=schedule,
        grad_clipping=True, noise=jnp.asarray(noise), block=128, interpret=True,
    )
    port = {
        "z0": torch.from_numpy(z0),
        "noise": torch.from_numpy(noise),
        "betas": torch.from_numpy(np.array(betas)),
        "eps": torch.tensor(0.1),
        "vd": {k: torch.from_numpy(np.array(v)) for k, v in params["vd"].items()},
        "sn": geffner_from_jax(jax.device_get(params["sn"]), device="cpu"),
    }
    jax_out = {"scan": (np.asarray(z_scan), np.asarray(w_scan)),
               "pallas": (np.asarray(z_pal), np.asarray(w_pal))}
    return getattr(tod, spec_name), schedule, port, jax_out


def _assert_matches(z, w, jax_out):
    for ref in ("scan", "pallas"):
        np.testing.assert_allclose(z, jax_out[ref][0], err_msg=ref, **Z_TOL)
        np.testing.assert_allclose(w, jax_out[ref][1], err_msg=ref, **W_TOL)


def test_fused_plain_twin_matches_jax_scan_and_pallas(case):
    spec, schedule, p, jax_out = case
    z, w = evolve_overdamped_fused(
        p["z0"], torch.zeros(N), p["betas"], p["eps"], p["vd"]["mean"],
        p["vd"]["logdiag"], make_many_gmm_score(), spec, dim=2, nbridges=K,
        sn=p["sn"], eps_schedule=schedule, grad_clipping=True, noise=p["noise"],
    )
    _assert_matches(z.numpy(), w.numpy(), jax_out)


def test_eager_integrator_matches_jax_scan_and_pallas(case):
    spec, schedule, p, jax_out = case
    ctx = TCtx(target_log_prob=load_target("many_gmm", device="cpu").log_prob, nbridges=K, dim=2,
               apply_sn=lambda net, x, i: net(x, i), eps_schedule=schedule,
               grad_clipping=True)
    params = {"vd": p["vd"], "eps": p["eps"], "sn": p["sn"]}
    with torch.no_grad():
        z, w, _ = tod.evolve_overdamped(p["z0"], p["betas"], params, ctx, spec,
                                        noise=p["noise"])
    _assert_matches(z.numpy(), w.numpy(), jax_out)


def _args():
    jt, params, betas, ctx, z0, noise = _case("")
    sn = geffner_from_jax(jax.device_get(params["sn"]), device="cpu")
    return (torch.from_numpy(z0), torch.zeros(N), torch.from_numpy(np.array(betas)),
            torch.tensor(0.1), torch.zeros(2), torch.full((2,), math.log(3.0)),
            make_many_gmm_score()), sn


@pytest.mark.parametrize("bad", ["spec", "score", "shape", "noise", "schedule"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    (z0, w0, betas, eps, mean, logdiag, score), sn = _args()
    kw = dict(dim=2, nbridges=K, sn=sn, grad_clipping=True)
    spec = tod.CAIS_VAR
    if bad == "spec":  # the net in both kernels, the backward net at i: no mode, no form
        spec = dataclasses.replace(tod.CAIS, bwd_sn_offset=0)
    elif bad == "score":
        score = lambda z: -z
    elif bad == "shape":
        w0 = torch.zeros(N + 1)
    elif bad == "noise":
        kw["noise"] = torch.zeros(K, N, 3)
    elif bad == "schedule":
        kw["eps_schedule"] = "exp"
    with pytest.raises((NotImplementedError, ValueError)):
        evolve_overdamped_fused(z0, w0, betas, eps, mean, logdiag, score, spec, **kw)


def test_wrapper_counts_no_launch_on_cpu():
    (z0, w0, betas, eps, mean, logdiag, score), sn = _args()
    before = evolve_overdamped_fused.launches
    z, w = evolve_overdamped_fused(z0, w0, betas, eps, mean, logdiag, score, tod.CAIS_VAR,
                                   dim=2, nbridges=K, sn=sn, grad_clipping=True, seed=3)
    assert evolve_overdamped_fused.launches == before
    assert z.shape == (N, 2) and w.shape == (N,) and torch.isfinite(w).all()


@pytest.mark.parametrize("with_trajectory", [True, False])
def test_noise_stack_is_what_the_rollout_used(with_trajectory):
    """return_noise hands back the draws: from a seed, the stack injected
    again gives the same z and w; injected noise is handed on as it is."""
    (z0, w0, betas, eps, mean, logdiag, score), sn = _args()
    kw = dict(dim=2, nbridges=K, sn=sn, grad_clipping=True,
              return_trajectory=with_trajectory, return_noise=True)
    out = evolve_overdamped_fused(z0, w0, betas, eps, mean, logdiag, score, tod.CAIS,
                                  seed=3, **kw)
    assert len(out) == 3 + with_trajectory
    draws = out[-1]
    assert draws.shape == (K, N, 2) and 0.8 < float(draws.std()) < 1.2
    again = evolve_overdamped_fused(z0, w0, betas, eps, mean, logdiag, score, tod.CAIS,
                                    noise=draws, **kw)
    assert again[-1] is draws
    for a, b in zip(out[:-1], again[:-1]):
        assert torch.equal(a, b)
    if with_trajectory:
        assert out[2].shape == (K + 1, N, 2) and torch.equal(out[2][K], out[0])
