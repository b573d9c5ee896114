"""The Bayesian logistic regressions (log_australian D=15, log_ionosphere
D=35, log_sonar D=61) in the port, against the JAX package on the CPU under
the same base normals and injected noise.

Layers: the data and the log-density against cmcd_tpu/targets/logreg.py;
the kernel-form score against make_logreg_grad_t and float64 jax.grad, its
Hessian product against a float64 jax.jvp of jax.grad; the eager KL
gradient at logits past 88; the plain CAIS rollout (B1's logreg instances'
plain version) against the JAX scan and evolve_overdamped_pallas in
interpret mode; the plain CAIS sweep (B3's) against jax.grad of the scan;
the fused KL loss against JAX's scan loss and kl_bound_pallas in interpret
mode; five MFVI-initialised MCD_CAIS_sn trainer steps against the JAX
trainer; the CLI on the CPU; the host's shared-memory formulas at the three
D; the refusals of every other mode and net before any launch; the
targets still unported; the port importing no JAX.

Tolerances: the data exact; the log-density and the score rtol 1e-5 of the
largest entry (float32), float64 to 1e-10; the rollout z to 2e-5 and w to
2e-4 absolute; gradients as tests/test_pallas_kl.py, |g_t - g_j| < 2e-4
|g_j| + 1e-4 over the flattened tree and per leaf; losses rtol 1e-4;
trainer leaves 2e-4.
"""

import filecmp
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

import cmcd_tpu
from cmcd_tpu import bounds as jb
from cmcd_tpu.distributions import diag_gaussian_log_prob as j_log_prob
from cmcd_tpu.integrators import overdamped as jod
from cmcd_tpu.ops.fused import _dim_pad
from cmcd_tpu.ops.fused_train import kl_bound_pallas
from cmcd_tpu.ops.pallas_overdamped import evolve_overdamped_pallas, pack_geffner_t
from cmcd_tpu.ops.target_grads import grad_t_for_target, make_logreg_grad_t
from cmcd_tpu.schedules import betas_from_grid as j_betas_from_grid
from cmcd_tpu.targets import logreg as jlogreg
from cmcd_tpu.train import trainer as jtrainer
from cmcd_tpu_torch import bounds as tb
from cmcd_tpu_torch.config import apply_lookup_tables
from cmcd_tpu_torch.integrators import OVERDAMPED, UNDERDAMPED
from cmcd_tpu_torch.integrators import overdamped as tod
from cmcd_tpu_torch.main import _use_fused, parse_flags, run_experiment
from cmcd_tpu_torch.ops import fused, fused_train, kl, overdamped, uha, underdamped, vargrad
from cmcd_tpu_torch.ops.fused import supports_fused
from cmcd_tpu_torch.ops.fused_train import (
    fused_training_path,
    kl_bound_fused,
    supports_fused_train,
)
from cmcd_tpu_torch.ops.kl import evolve_kl_bwd
from cmcd_tpu_torch.ops.overdamped import evolve_overdamped_fused, evolve_overdamped_fused_plain
from cmcd_tpu_torch.ops.target_grads import (
    KERNEL_DIMS,
    LOGREG_TARGETS,
    TARGETS,
    kernel_data,
    kernel_target,
    score_for_target,
)
from cmcd_tpu_torch.schedules import betas_from_grid
from cmcd_tpu_torch.targets import Target, load_target
from cmcd_tpu_torch.targets import logreg as tlogreg
from cmcd_tpu_torch.train import train
from cmcd_tpu_torch.utils.convert import grads_to_numpy, params_from_jax, params_to_numpy
from test_torch_ula import OTHER_WRAPPERS
from test_torch_vargrad import assert_grads_close, torch_value_and_grad

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETS = {"log_australian": 15, "log_ionosphere": 35, "log_sonar": 61}
K, N, EMB = 6, 64, 16
Z_ATOL, W_ATOL = 2e-5, 2e-4


def points(dim, n, seed, scale=0.3):
    """(n, dim) float64 weights, standard normal times `scale`."""
    return scale * np.random.default_rng(seed).standard_normal((n, dim))


# --- the data, the density, the score and its Hessian product ---------------

@pytest.mark.parametrize("model", SETS)
def test_data_matches_the_jax_package_exactly(model):
    """The port's copy of the dataset is the JAX package's file byte for
    byte, and X (bias column first, z-scored) and y ({0, 1}) are the same
    float32 bits; the kernels' copy is X^T then y."""
    dset = model[len("log_"):]
    assert filecmp.cmp(os.path.join(REPO, "cmcd_tpu", "targets", "data", f"{dset}.npz"),
                       os.path.join(tlogreg.DATA_DIR, f"{dset}.npz"), shallow=False)
    x_j, y_j = (np.asarray(a) for a in jlogreg.load_logreg_data(dset))
    x, y = tlogreg.load_logreg_data(dset)
    assert x.dtype == y.dtype == np.float32 and x.shape[1] == SETS[model] == KERNEL_DIMS[model]
    np.testing.assert_array_equal(x, x_j)
    np.testing.assert_array_equal(y, y_j)
    assert set(np.unique(y)) == {0.0, 1.0} and np.all(x[:, 0] == 1.0)
    target = load_target(model, device="cpu")
    assert (target.name, target.dim, target.params) == (model, SETS[model], {"dset": dset})
    score = score_for_target(target)
    data, n_data = kernel_data(score)
    assert n_data == x.shape[0] and data.is_contiguous()
    np.testing.assert_array_equal(data.numpy(), np.concatenate([x.T.ravel(), y]))
    code, tpar, inv_var = kernel_target(score, "cpu")
    assert (code, tpar.tolist(), inv_var) == (TARGETS[model], [1.0], 0.0)


@pytest.mark.parametrize("model", SETS)
def test_log_prob_matches_jax(model):
    target, j_target = load_target(model, device="cpu"), cmcd_tpu.load_target(model)
    w = points(target.dim, 64, 0, scale=1.0).astype(np.float32)
    want = np.asarray(j_target.log_prob(jnp.asarray(w)))
    got = target.log_prob(torch.from_numpy(w)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    with enable_x64():
        want64 = np.asarray(j_target.log_prob(jnp.asarray(w, jnp.float64)))
    got64 = target.log_prob(torch.from_numpy(w).double()).numpy()
    assert np.abs(got64 - want64).max() <= 1e-6 * np.abs(want64).max()  # the data is float32


@pytest.mark.parametrize("model", SETS)
@pytest.mark.parametrize("scale", [0.3, 10.0])
def test_score_matches_jax_kernel_form_and_float64_grad(model, scale):
    """LogregScore against the JAX kernels' score (make_logreg_grad_t, its
    transposed, padded layout) in float32 and against jax.grad of the JAX
    log-density in float64; at scale 10 the logits pass 88."""
    dim = SETS[model]
    target = load_target(model, device="cpu")
    score = score_for_target(target)
    w = points(dim, 32, 1, scale)
    dim_pad = _dim_pad(dim)
    grad_t = make_logreg_grad_t(model[len("log_"):], dim, dim_pad)
    w_t = jnp.zeros((dim_pad, 32), jnp.float32).at[:dim].set(jnp.asarray(w.T, jnp.float32))
    want = np.asarray(grad_t(w_t))[:dim].T
    got = score(torch.from_numpy(w.astype(np.float32))).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    j_target = cmcd_tpu.load_target(model)
    with enable_x64():
        want64 = np.asarray(jax.grad(lambda v: jnp.sum(j_target.log_prob(v)))(
            jnp.asarray(w, jnp.float64)))
    got64 = score(torch.from_numpy(w)).numpy()
    assert np.abs(got64 - want64).max() <= 1e-10 * np.abs(want64).max()
    if scale > 1:
        assert float((torch.from_numpy(w) @ score.x.double().T).abs().max()) > 88


@pytest.mark.parametrize("model", SETS)
@pytest.mark.parametrize("scale", [0.3, 10.0])
def test_hvp_matches_float64_jax_hessian_product(model, scale):
    """LogregScore.hvp against jax.jvp of jax.grad of the JAX log-density in
    float64 (the Pallas sweep traces the product; the port states it), and
    the CPU probe (ops/overdamped.logreg_score_probe) gives the plain pair."""
    dim = SETS[model]
    score = score_for_target(load_target(model, device="cpu"))
    w, u = points(dim, 32, 2, scale), points(dim, 32, 3, 1.0)
    j_target = cmcd_tpu.load_target(model)
    with enable_x64():
        grad = jax.grad(lambda v: jnp.sum(j_target.log_prob(v)))
        want = np.asarray(jax.jvp(grad, (jnp.asarray(w),), (jnp.asarray(u),))[1])
    got = score.hvp(torch.from_numpy(w), torch.from_numpy(u)).numpy()
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    w32, u32 = torch.from_numpy(w.astype(np.float32)), torch.from_numpy(u.astype(np.float32))
    g_p, h_p = overdamped.logreg_score_probe(score, w32, u32)
    assert torch.equal(g_p, score(w32)) and torch.equal(h_p, score.hvp(w32, u32))
    assert np.abs(h_p.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_eager_kl_gradient_stays_finite_past_logit_88():
    """The eager KL loss differentiates the score, so the log-likelihood's
    second derivative must stay finite where |x . w| passes 88 (written as
    y l + logsigmoid(-l); logaddexp(0, l)'s is NaN there in torch)."""
    target = load_target("log_sonar", device="cpu")
    w = torch.from_numpy(points(61, 8, 4, 10.0)).float().requires_grad_(True)
    assert float((w.detach() @ target.constants["x"].T).abs().max()) > 88
    g, = torch.autograd.grad(target.log_prob(w).sum(), w, create_graph=True)
    h, = torch.autograd.grad((g * torch.ones_like(g)).sum(), w)
    assert torch.isfinite(g).all() and torch.isfinite(h).all()
    setup = tb.CMCDSetup(mode="MCD_CAIS_sn", dim=61, nbridges=4, emb_dim=8, grad_clipping=True)
    params, ctx = tb.initialize(setup, target.log_prob, eps=0.01,
                                trainable=tb.default_trainable("MCD_CAIS_sn", True, True),
                                device="cpu")
    with torch.no_grad():
        params["train"]["vd"]["logdiag"].fill_(np.log(10.0))
    leaves = [params["train"]["eps"], *params["train"]["vd"].values(),
              *params["train"]["sn"].parameters()]
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, _ = tb.kl_bound(params, 16, ctx, setup, generator=torch.Generator().manual_seed(0))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads if g is not None)


# --- the kernels' plain versions against the JAX package --------------------

def make_case(model, n=N, k=K, eps=0.01, train_eps=True, grad_clipping=True, vd=None, seed=2):
    """One MCD_CAIS_sn problem on a logistic regression in both packages:
    eps, vd and the beta knots trainable, non-uniform knots, a net with
    factor_sn 0.3 and a random head, the variational distribution near the
    posterior's scale (vd: JAX's vd params, e.g. from MFVI; default mean
    +-0.1, scale 0.3)."""
    jt = cmcd_tpu.load_target(model)
    dim = jt.dim
    kw = dict(mode="MCD_CAIS_sn", dim=dim, nbridges=k, emb_dim=EMB, grad_clipping=grad_clipping)
    jsetup = jb.CMCDSetup(**kw)
    trainable = jb.default_trainable("MCD_CAIS_sn", train_eps=train_eps, train_vi=True)
    params, jctx = jb.initialize(jsetup, jt.log_prob, eps=eps, init_sigma=0.3,
                                 trainable=trainable)
    sn = params["train"]["sn"]
    sn["factor_sn"] = jnp.asarray(0.3)
    sn["head"]["w"] = 0.05 * jax.random.normal(jax.random.PRNGKey(9), sn["head"]["w"].shape)
    params["train"]["mgridref_y"] = jax.random.uniform(
        jax.random.PRNGKey(4), params["train"]["mgridref_y"].shape, minval=0.5, maxval=1.5)
    params["train"]["vd"] = vd if vd is not None else {
        "mean": jnp.asarray([0.1 * (-1) ** d for d in range(dim)], jnp.float32),
        "logdiag": jnp.full((dim,), np.log(0.3), jnp.float32)}
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, dim)).astype(np.float32)
    noise = rng.standard_normal((k, n, dim)).astype(np.float32)
    target = load_target(model, device="cpu")
    tsetup = tb.CMCDSetup(**kw)
    _, tctx = tb.initialize(tsetup, target.log_prob, device="cpu")
    return {
        "jt": jt, "jsetup": jsetup, "jparams": params, "jctx": jctx, "key": jax.random.PRNGKey(0),
        "jnoise": jnp.asarray(noise), "jbase": jnp.asarray(base), "n": n, "k": k, "dim": dim,
        "rng": rng, "target": target, "setup": tsetup, "ctx": tctx, "trainable": trainable,
        "params": params_from_jax(jax.device_get(params), device="cpu"),
        "draws": {"base_normals": torch.from_numpy(base), "noise": torch.from_numpy(noise)},
    }


def port_args(case):
    """(z0, the port rollout's arguments after w0, its keywords)."""
    p = tb.merged_params(case["params"])
    betas = betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"]).detach()
    z0 = (p["vd"]["mean"] + torch.exp(p["vd"]["logdiag"]) * case["draws"]["base_normals"]).detach()
    args = (betas, p["eps"].detach(), p["vd"]["mean"].detach(), p["vd"]["logdiag"].detach(),
            score_for_target(case["target"]), tod.CAIS)
    kw = dict(dim=case["dim"], nbridges=case["k"], sn=p["sn"],
              grad_clipping=case["setup"].grad_clipping)
    return z0, args, kw


def jax_scan(case):
    """The JAX scan integrator as a function of (theta, z0): (z_K, w_delta),
    with theta and z0 at the case's values."""
    p = jb.merged_params(case["jparams"])

    def run(theta, z0):
        q = dict(p, eps=theta["eps"], sn=theta["sn"],
                 vd={"mean": theta["vd_mean"], "logdiag": theta["vd_logdiag"]})
        z, w, _ = jod.evolve_overdamped(case["key"], z0, theta["betas"], q, case["jctx"],
                                        jod.CAIS, noise=case["jnoise"])
        return z, w

    theta = {"eps": p["eps"], "sn": p["sn"], "vd_mean": p["vd"]["mean"],
             "vd_logdiag": p["vd"]["logdiag"],
             "betas": j_betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])}
    return run, theta, p["vd"]["mean"] + jnp.exp(p["vd"]["logdiag"]) * case["jbase"]


@pytest.mark.parametrize("model", SETS)
def test_plain_rollout_matches_jax_scan_and_pallas_kernel(model):
    """B1's logreg instances' plain version under injected noise (grad
    clipping on, as the posterior protocol): z, w and the stored path
    against the JAX scan and against evolve_overdamped_pallas in interpret
    mode; the CPU wrapper launches nothing."""
    case = make_case(model)
    n, k, dim = case["n"], case["k"], case["dim"]
    run, theta, z0_j = jax_scan(case)
    z_s, w_s = run(theta, z0_j)
    p = jb.merged_params(case["jparams"])
    dim_pad = _dim_pad(dim)
    sn_w, sn_meta = pack_geffner_t(p["sn"], dim, dim_pad)
    z_j, w_j, traj_t = evolve_overdamped_pallas(
        z0_j, jnp.zeros(n), theta["betas"], p["eps"], p["vd"]["mean"], p["vd"]["logdiag"],
        grad_t_for_target(case["jt"], dim_pad), jod.CAIS, dim=dim, nbridges=k, sn_weights=sn_w,
        sn_meta=sn_meta, grad_clipping=True, block=128, interpret=True, noise=case["jnoise"],
        return_trajectory_t=True)
    z0, args, kw = port_args(case)
    before = evolve_overdamped_fused.launches
    z, w, traj = evolve_overdamped_fused(z0, torch.zeros(n), *args, noise=case["draws"]["noise"],
                                         return_trajectory=True, **kw)
    assert evolve_overdamped_fused.launches == before
    for z_want, w_want in ((z_s, w_s), (z_j, w_j)):
        np.testing.assert_allclose(z.numpy(), np.asarray(z_want), atol=Z_ATOL, rtol=1e-5)
        np.testing.assert_allclose(w.numpy(), np.asarray(w_want), atol=W_ATOL, rtol=1e-5)
    want_traj = np.asarray(traj_t)[:, :dim, :n].transpose(0, 2, 1)
    np.testing.assert_allclose(traj.numpy(), want_traj, atol=Z_ATOL, rtol=1e-5)
    assert torch.equal(traj[0], z0) and torch.equal(traj[k], z)


@pytest.mark.parametrize("model", SETS)
def test_plain_sweep_matches_jax_grad_of_the_scan(model):
    """sum_n [c_n w_delta_n + g_n . z_K] in theta and z0: B3's logreg
    instances' plain version on the plain rollout's path against jax.grad
    through the scan, and the same sweep in float64 (the card's arbiter)
    within float32's reach of it."""
    case = make_case(model)
    n, dim = case["n"], case["dim"]
    run, theta, z0_j = jax_scan(case)
    cot = case["rng"].standard_normal(n).astype(np.float32)
    g_zf = case["rng"].standard_normal((n, dim)).astype(np.float32)

    def objective(theta, z0):
        z, w = run(theta, z0)
        return jnp.sum(cot * w) + jnp.sum(g_zf * z)

    want, want_z0 = jax.grad(objective, argnums=(0, 1))(theta, z0_j)
    z0, args, kw = port_args(case)
    _, _, traj, noise = evolve_overdamped_fused_plain(
        z0, torch.zeros(n), *args, noise=case["draws"]["noise"], return_trajectory=True,
        return_noise=True, **kw)
    before = evolve_kl_bwd.launches
    got, got_z0 = evolve_kl_bwd(traj, noise, torch.from_numpy(cot), torch.from_numpy(g_zf),
                                *args, **kw)
    assert evolve_kl_bwd.launches == before
    sn = tb.merged_params(case["params"])["sn"]
    for name, param in sn.named_parameters():
        param.grad = got["sn"][name]
    got_tree = {"eps": got["eps"].numpy(), "betas": got["betas"].numpy(),
                "vd_mean": got["vd_mean"].numpy(), "vd_logdiag": got["vd_logdiag"].numpy(),
                "sn": grads_to_numpy(sn)}
    assert_grads_close(got_tree, jax.device_get(want), rel=2e-4)
    want_z0 = np.asarray(want_z0)
    assert np.linalg.norm(got_z0.numpy() - want_z0) < 2e-4 * np.linalg.norm(want_z0) + 1e-4
    got64, got64_z0 = evolve_kl_bwd(traj.double(), noise.double(), torch.from_numpy(cot),
                                    torch.from_numpy(g_zf), *args, **kw)
    assert np.linalg.norm(got64_z0.numpy() - got_z0.numpy()) < 1e-5 * np.linalg.norm(want_z0)


def jax_scan_loss(case):
    def loss(train_p):
        p = jb.merged_params({"train": train_p, "notrain": case["jparams"]["notrain"]})
        z = p["vd"]["mean"] + jnp.exp(p["vd"]["logdiag"]) * case["jbase"]
        w = -j_log_prob(p["vd"], z)
        betas = j_betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])
        z, wd, _ = jod.evolve_overdamped(case["key"], z, betas, p, case["jctx"], jod.CAIS,
                                         noise=case["jnoise"])
        return jnp.mean(-(w + wd + case["jctx"].target_log_prob(z)))

    return loss


@pytest.mark.parametrize("model", SETS)
def test_kl_bound_fused_matches_jax_scan_and_kl_bound_pallas(model):
    """The posterior protocol's loss (MCD_CAIS_sn, grad clipping, eps and
    vd trained) through the fused path's plain versions: loss and every
    leaf against JAX's scan loss, and against JAX's fused loss
    (kl_bound_pallas, interpret mode) at the base draw JAX takes from its
    key; the CPU path launches nothing."""
    case = make_case(model)
    fused_loss = lambda p, n_, c, s, **d: kl_bound_fused(p, n_, c, s, case["target"], **d)
    before = (evolve_overdamped_fused.launches, evolve_kl_bwd.launches)
    got_l, got_g = torch_value_and_grad(case, fused_loss)
    want_l, want_g = jax.value_and_grad(jax_scan_loss(case))(case["jparams"]["train"])
    np.testing.assert_allclose(got_l, float(want_l), rtol=1e-4)
    assert_grads_close(got_g, want_g, rel=2e-4)
    assert np.linalg.norm(got_g["vd"]["mean"]) > 1e-3 and abs(float(got_g["eps"])) > 0
    z_key = jax.random.split(case["key"])[0]
    case["draws"]["base_normals"] = torch.from_numpy(
        np.array(jax.random.normal(z_key, (case["n"], case["dim"])), np.float32))

    def pallas_loss(train_p):
        return kl_bound_pallas({"train": train_p, "notrain": case["jparams"]["notrain"]},
                               case["key"], case["n"], case["jctx"], case["jsetup"], case["jt"],
                               block=128, noise=case["jnoise"], interpret=True)[0]

    got_l, got_g = torch_value_and_grad(case, fused_loss)
    want_l, want_g = jax.value_and_grad(pallas_loss)(case["jparams"]["train"])
    np.testing.assert_allclose(got_l, float(want_l), rtol=1e-4)
    assert_grads_close(got_g, want_g, rel=2e-4)
    assert (evolve_overdamped_fused.launches, evolve_kl_bwd.launches) == before


STEPS = 5


def test_five_mfvi_initialised_steps_match_the_jax_trainer():
    """log_sonar with the posterior protocol's flags (MCD_CAIS_sn, init_eps
    0.01, train_vi, train_eps, grad clipping, lr 1e-3 from LR_DICT) at N=64,
    K=6, emb 16, the variational distribution from JAX's MFVI pretraining
    (200 iterations), in both packages' trainers under the same draws, the
    fused KL loss on the port's side: losses and every parameter after five
    Adam steps."""
    model = "log_sonar"
    j_target = cmcd_tpu.load_target(model)
    vd, _, _ = jtrainer.mfvi_pretrain(j_target.dim, j_target.log_prob, lr=0.01, iters=200,
                                      batch_size=64, key=jax.random.PRNGKey(1))
    case = make_case(model, vd=jax.device_get(vd))
    n, k, dim = case["n"], case["k"], case["dim"]
    rng = np.random.default_rng(11)
    draws = [(rng.standard_normal((n, dim)).astype(np.float32),
              rng.standard_normal((k, n, dim)).astype(np.float32)) for _ in range(STEPS)]
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
        z, wd, _ = jod.evolve_overdamped(step_key, z, betas, p, ctx, jod.CAIS,
                                         noise=noise_all[t])
        neg = -(w + wd + ctx.target_log_prob(z))
        return jnp.mean(neg), (neg, z)

    trainable = case["trainable"]
    assert "eps" in trainable and "vd" in trainable
    want = jtrainer.train(case["jsetup"], case["jparams"], case["jctx"], lr=1e-3, iters=STEPS,
                          batch_size=n, key=jax.random.PRNGKey(0), trainable=trainable,
                          loss_fn=j_loss, log_every=1, steps_per_call=1)
    step = {"i": 0}

    def loss_fn(params, n_, ctx, setup, generator=None):
        base, noise = draws[step["i"]]
        step["i"] += 1
        return kl_bound_fused(params, n_, ctx, setup, case["target"],
                              base_normals=torch.from_numpy(base), noise=torch.from_numpy(noise))

    got = train(case["setup"], case["params"], case["ctx"], lr=1e-3, iters=STEPS,
                batch_size=n, trainable=trainable, loss_fn=loss_fn, log_every=1)
    assert got.steps_done == STEPS and not got.diverged and not bool(want.diverged)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses), rtol=1e-4)
    got_l, treedef = jax.tree_util.tree_flatten(params_to_numpy(got.params["train"]))
    want_l, want_def = jax.tree_util.tree_flatten(jax.device_get(want.params["train"]))
    assert treedef == want_def
    for g, w in zip(got_l, want_l):
        assert np.linalg.norm(g - w) <= 2e-4 * np.linalg.norm(w) + 1e-7
    assert not np.allclose(params_to_numpy(got.params["train"])["vd"]["mean"],
                           np.asarray(vd["mean"]))


# --- the CLI, the gates and the refusals ------------------------------------

TINY = ("--config.model log_ionosphere --config.boundmode MCD_CAIS_sn --config.N 32 "
        "--config.nbridges 4 --config.emb_dim 20 --config.init_eps 0.01 "
        "--config.train_vi True --config.train_eps True --config.grad_clipping True "
        "--config.mfvi_iters 20 --config.iters 10 --config.n_samples 16 "
        "--config.n_input_dist_seeds 2 --config.log.every 1").split()


def test_cli_trains_log_ionosphere_on_cpu_through_the_overdamped_wrappers(monkeypatch, capsys):
    """The posterior protocol's flags cut to N=32, K=4, 20 MFVI and 10 KL
    steps through the CLI on the CPU: LR_DICT sets lr 1e-4; MFVI (eager),
    the fused KL loss (the plain rollout and sweep) and the fused evaluation,
    no other kernel's wrapper. log_australian has no LR_DICT row: "LR not
    found" is printed and the default lr kept, as the JAX package does."""
    def refuse(name):
        def fn(*a, **k):
            raise AssertionError(f"the logreg path called {name}")
        return fn

    for module, names in OTHER_WRAPPERS.items():
        for name in names:
            monkeypatch.setattr(module, name, refuse(name))
    calls = {"rollout": 0, "sweep": 0}

    def spy(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            assert a[0].shape[-1] == 35
            return fn(*a, **k)
        return wrapped

    rollout = spy("rollout", overdamped.evolve_overdamped_fused)
    monkeypatch.setattr(overdamped, "evolve_overdamped_fused", rollout)
    monkeypatch.setattr(fused_train, "evolve_overdamped_fused", rollout)
    monkeypatch.setattr(fused_train, "evolve_kl_bwd", spy("sweep", kl.evolve_kl_bwd))
    cfg = parse_flags(TINY)
    out = run_experiment(cfg, device="cpu")
    printed = capsys.readouterr().out
    assert "kl_bound_fused, KL reverse sweep" in printed
    assert "Done training initial parameters" in printed
    assert cfg.lr == 1e-4
    assert calls == {"rollout": 10 + 2, "sweep": 10}
    result = out["train"]
    assert result.steps_done == 10 and not result.diverged
    assert torch.isfinite(result.losses).all()
    assert np.isfinite(out["final_elbo"]) and out["neg_elbos"].shape == (2, 16)
    assert out["samples"].shape == (2 * 16, 35)
    flags = lambda model: parse_flags(["--config.model", model, "--config.boundmode",
                                       "MCD_CAIS_sn"])
    assert apply_lookup_tables(flags("log_australian")) == {}
    assert "LR not found for model log_australian" in capsys.readouterr().out
    assert apply_lookup_tables(flags("log_sonar")) == {"lr": 1e-3}


def test_host_limits_at_the_logreg_dims():
    """The shared-memory formulas the wrappers hold against the kernels'
    (ops/*._library) at the protocol's emb 20 (in_dim D + 20, one float of
    target constants; the dataset is read in place and costs no shared
    memory): at D = 61 (in_dim 81, in_pad 84) the rollout takes 84^2 +
    61*84 + 2*8*84 + 4 + 3*8*61 floats, and the KL sweep's tile of four
    groups 2*84*85 + 2*32*84 + 84*36 + 61*84 + 4 + 188*20, with 428 floats a
    chain and 488 a warp: 220 096 bytes of the 232 448 a block may have."""
    assert overdamped.smem_bytes(81, 1, 61) == 4 * 14992
    assert vargrad.tile_floats(4, 81, 1, 61) == 31568
    assert kl.extra_floats(61) == (428, 488)
    assert vargrad.smem_bytes(81, 1, 4, kl.extra_floats(61), dim=61) == 220096
    for model, dim in SETS.items():
        assert kl.kernel_fits(dim + 20, 1, dim) and overdamped.kernel_fits(dim + 20, 1, dim)
        assert supports_fused_train(tb.CMCDSetup(mode="MCD_CAIS_sn", dim=dim, nbridges=8,
                                                 emb_dim=20), load_target(model, device="cpu"))
    # The widest geffner net the sweep takes at D = 61 is 88 features (emb 27):
    # past it training is refused, while the rollout (evaluation) goes wider.
    assert kl.kernel_fits(88, 1, 61) and not kl.kernel_fits(89, 1, 61)
    wide = tb.CMCDSetup(mode="MCD_CAIS_sn", dim=61, nbridges=8, emb_dim=28)
    sonar = load_target("log_sonar", device="cpu")
    assert supports_fused(wide, sonar) and not supports_fused_train(wide, sonar)


def test_refusals_before_any_launch():
    """On the logistic regressions the kernels take MCD_CAIS_sn with the
    geffner net only: every other mode (VarGrad, ULA, ULA_sn, DNF, the seven
    underdamped ones, UHA) and the PIS nets are refused by the gates, and
    the card's path raises for them before anything launches; the wrappers
    raise on those forms on either device; a logreg Target built outside
    make_logreg gets no score."""
    for model, dim in SETS.items():
        target = load_target(model, device="cpu")
        ok = tb.CMCDSetup(mode="MCD_CAIS_sn", dim=dim, nbridges=8, emb_dim=20)
        assert supports_fused(ok, target) and supports_fused_train(ok, target)
        assert fused_training_path(ok, 300)[1] == "kl_bound_fused, KL reverse sweep"
        refused = [tb.CMCDSetup(mode=mode, dim=dim, nbridges=8, emb_dim=20)
                   for mode in [*OVERDAMPED, *UNDERDAMPED, "UHA"] if mode != "MCD_CAIS_sn"]
        refused += [tb.CMCDSetup(mode="MCD_CAIS_sn", dim=dim, nbridges=8, nn_arch=arch,
                                 fully_connected_units=(16, 16)) for arch in ("dds", "dds_grad")]
        for setup in refused:
            assert not supports_fused(setup, target), setup.mode
            assert not supports_fused_train(setup, target), setup.mode
            with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
                _use_fused("training", True, supports_fused_train(setup, target),
                           torch.device("cuda"), setup, target)
    score = score_for_target(load_target("log_sonar", device="cpu"))
    dim, k = 61, 4
    z, zeros = torch.zeros(8, dim), torch.zeros(dim)
    case = make_case("log_sonar", n=8, k=k)
    sn = tb.merged_params(case["params"])["sn"]
    counters = (evolve_overdamped_fused, evolve_kl_bwd, vargrad.evolve_vargrad_bwd_replay,
                underdamped.evolve_underdamped_fused)
    before = [fn.launches for fn in counters]
    for spec, net in ((tod.ULA, None), (tod.ULA_SN, sn), (tod.CAIS_VAR, sn)):
        with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
            evolve_overdamped_fused(z, torch.zeros(8), torch.ones(k), 0.01, zeros, zeros, score,
                                    spec, dim=dim, nbridges=k, sn=net)
    traj, noise = torch.zeros(k + 1, 8, dim), torch.zeros(k, 8, dim)
    with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
        evolve_kl_bwd(traj, noise, torch.zeros(8), z, torch.ones(k), 0.01, zeros, zeros, score,
                      tod.ULA_SN, dim=dim, nbridges=k, sn=sn)
    with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
        vargrad.evolve_vargrad_bwd_replay(traj, torch.zeros(8), torch.ones(k), 0.01, zeros,
                                          zeros, score, tod.CAIS_VAR, dim=dim, nbridges=k, sn=sn)
    with pytest.raises(NotImplementedError):
        underdamped.evolve_underdamped_fused(
            z, torch.zeros(8), torch.ones(k), 0.01, 1.0, 0.5, zeros, zeros, score,
            UNDERDAMPED["MCD_U_a-lp"], dim=dim, nbridges=k)
    with pytest.raises(NotImplementedError):
        uha.check_config("UHA", score, dim, k, 1)
    assert [fn.launches for fn in counters] == before
    bare = Target("log_sonar", dim, load_target("log_sonar", device="cpu").log_prob)
    assert score_for_target(bare) is None and not supports_fused(
        tb.CMCDSetup(mode="MCD_CAIS_sn", dim=dim, nbridges=8, emb_dim=20), bare)
    assert set(LOGREG_TARGETS) == set(SETS) and fused.LOGREG_MODES == ("MCD_CAIS_sn",)


@pytest.mark.parametrize("name", ["log_a1a", "log_madelon", "banana", "brownian", "seeds",
                                  "lorenz", "nice"])
def test_the_targets_still_to_port_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP queue A"):
        load_target(name, device="cpu")


def test_the_logreg_modules_import_no_jax():
    """A fresh interpreter that refuses JAX and the JAX package imports the
    modules this slice adds and changes, and the data files it reads are the
    port's own (nothing under cmcd_tpu/)."""
    code = """
import importlib, sys
BANNED = ("jax", "jaxlib", "cmcd_tpu", "absl", "ml_collections", "optax", "orbax")
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("the port imported " + name)
sys.meta_path.insert(0, Refuse())
for name in ("targets.logreg", "targets", "ops.target_grads", "ops.overdamped", "ops.kl",
             "ops.fused", "ops.fused_train", "main"):
    importlib.import_module("cmcd_tpu_torch." + name)
from cmcd_tpu_torch.targets import load_target
t = load_target("log_sonar", device="cpu")
assert t.dim == 61 and "jax" not in sys.modules
print("clean")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "clean", out.stderr
    assert os.path.dirname(tlogreg.DATA_DIR).endswith(os.path.join("cmcd_tpu_torch", "targets"))
    for src in ("overdamped_logreg.cu", "kl_logreg.cu", "overdamped_rollout.cuh",
                "kl_sweep.cuh"):
        assert os.path.exists(os.path.join(REPO, "cmcd_tpu_torch", "csrc", src)), src
