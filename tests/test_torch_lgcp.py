"""The 1600-D LGCP in the port (targets/lgcp.py, ops/target_grads.LgcpScore,
the wide rollout ops/overdamped_wide.py and the split KL sweep
ops/kl_split.py), against the JAX package on the CPU under the same base
normals and injected noise.

Layers: the target (log-densities, bin counts, Gram matrix) against
cmcd_tpu/targets/lgcp.py; the kernel-form score and its Hessian product
against make_lgcp_grad_t (values and custom VJP) and against float64
autograd of the port's log-density; the eager kl_bound against JAX's scan
loss; the plain wide rollout against JAX's scan integrator and its Pallas
rollout in interpret mode; the plain split sweep against JAX's split
Pallas sweep in interpret mode at many_gmm's size, and its weight gradients
against the port's carry sweep; five lgcp_k8-flag trainer steps against the
JAX trainer; a short CPU run through the CLI; the refusals of everything the
wide forms do not take, before any launch.

Tolerances. The log-density rtol 1e-5 (float32 sums of 1600 terms of size
~1e3). The score: its float32 products of 1600 terms against JAX's, 1e-5 of
the largest entry. The rollout: z to 1e-5 absolute (|z| ~ 4, an ulp is 5e-7
and two steps move it by eps * score); w to 2e-2 absolute, because the
log-weight sums 1600 squared residuals divided by the step scale sqrt(2 eps)
(eps 1e-3 here), so an ulp of z becomes 2e-5 of a residual. Gradients as
tests/test_pallas_kl.py: |g_t - g_j| < 2e-4 |g_j| + 1e-4 over the flattened
tree and per leaf; losses rtol 1e-4; trainer parameters 2e-4 per leaf (Adam
divides by the gradients' running scale). The split sweep against JAX's
split kernel: the same, since JAX rebuilds each draw from the trajectory
where the port reads the stored one (about an ulp of z over the step scale,
~1e-6 of a draw at many_gmm's eps 0.1).
"""

import os

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
from cmcd_tpu.ops.pallas_kl import evolve_kl_bwd_pallas
from cmcd_tpu.ops.pallas_overdamped import evolve_overdamped_pallas, pack_geffner_t
from cmcd_tpu.ops.target_grads import grad_t_for_target, make_lgcp_grad_t
from cmcd_tpu.schedules import betas_from_grid as j_betas_from_grid
from cmcd_tpu.targets import lgcp as jlgcp
from cmcd_tpu.train import trainer as jtrainer
from cmcd_tpu_torch import bounds as tb
from cmcd_tpu_torch.integrators import overdamped as tod
from cmcd_tpu_torch.main import parse_flags, run_experiment
from cmcd_tpu_torch.ops import fused_train, kl_split, overdamped, overdamped_wide
from cmcd_tpu_torch.ops.fused import supports_fused
from cmcd_tpu_torch.ops.fused_train import (
    fused_training_path,
    kl_bound_fused,
    net_bytes,
    supports_fused_train,
)
from cmcd_tpu_torch.ops.kl import evolve_kl_bwd_plain
from cmcd_tpu_torch.ops.kl_split import evolve_kl_split, evolve_kl_split_plain
from cmcd_tpu_torch.ops.overdamped import evolve_overdamped_fused
from cmcd_tpu_torch.ops.overdamped_wide import evolve_overdamped_wide
from cmcd_tpu_torch.ops.target_grads import (
    TARGETS,
    LgcpScore,
    kernel_target,
    lgcp_score,
    make_many_gmm_score,
    score_for_target,
)
from cmcd_tpu_torch.schedules import betas_from_grid
from cmcd_tpu_torch.targets import load_target
from cmcd_tpu_torch.targets import lgcp as tlgcp
from cmcd_tpu_torch.tools import log_summary
from cmcd_tpu_torch.train import train
from cmcd_tpu_torch.train.trainer import double_tree
from cmcd_tpu_torch.utils.convert import (
    geffner_from_jax,
    grads_to_numpy,
    params_from_jax,
    params_to_numpy,
)
from test_torch_kl import _jax_forward, _port_args, _to_jax_layout
from test_torch_kl import make_case as many_gmm_case
from test_torch_ula import OTHER_WRAPPERS
from test_torch_vargrad import assert_grads_close

torch.set_num_threads(1)

D, EMB = 1600, 20
MU = np.log(126.0) - 0.5 * 1.91
JAX_DATA = os.path.join(os.path.dirname(jlgcp.__file__), "data", "pines.csv")


def _config(**kw):
    return type("C", (), kw)()


def lgcp_points(n, seed, where):
    """(n, dim) float64 points: "init" the variational draw at mean 0, sigma
    1 (the MFVI start, far below the posterior's mu ~ 3.9, e^z small); "moved"
    around mu with the prior's spread (e^z ~ 50, a e^z ~ 0.03)."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, D))
    return z if where == "init" else MU + 1.2 * z


@pytest.mark.parametrize("whitened", [False, True])
@pytest.mark.parametrize("num_dim", [1600, 400])
def test_lgcp_target_matches_jax(whitened, num_dim):
    """log p of both packages on the same points, and the grid, the bin
    counts and the Gram matrix equal; the port reads its own pines.csv."""
    z = np.random.default_rng(0).standard_normal((8, num_dim)).astype(np.float32) + 2.0
    got_t = tlgcp.make_lgcp(whitened, num_dim=num_dim, device="cpu")
    want_t = jlgcp.make_lgcp(whitened, num_dim=num_dim)
    got = got_t.log_prob(torch.from_numpy(z)).numpy()
    want = np.asarray(want_t.log_prob(jnp.asarray(z)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got_t.params == want_t.params == {"use_whitened": whitened, "num_dim": num_dim,
                                             "default_data": True}
    grid = int(np.sqrt(num_dim))
    pines = np.genfromtxt(tlgcp.DATA_PATH, delimiter=",")
    assert tlgcp.DATA_PATH != JAX_DATA and np.array_equal(
        pines, np.genfromtxt(JAX_DATA, delimiter=","))
    assert np.array_equal(tlgcp.get_bin_counts(pines, grid), jlgcp.get_bin_counts(pines, grid))
    assert np.array_equal(tlgcp.get_bin_vals(grid), jlgcp.get_bin_vals(grid))
    vals = tlgcp.get_bin_vals(grid)
    assert np.array_equal(tlgcp.gram_matrix(vals, 1.91, grid, 1 / 33),
                          jlgcp.gram_matrix(vals, 1.91, grid, 1 / 33))
    z64 = torch.from_numpy(z.astype(np.float64))
    assert got_t.log_prob(z64).dtype == torch.float64


def _jax_score_t(whitened):
    return make_lgcp_grad_t(_dim_pad(D), use_whitened=whitened)


@pytest.mark.parametrize("whitened", [False, True])
@pytest.mark.parametrize("where", ["init", "moved"])
def test_lgcp_score_and_hvp_match_jax_kernel_form(whitened, where):
    """The score and H u against make_lgcp_grad_t (the JAX kernels'
    transposed layout, float32) and its hand-written custom VJP."""
    z = lgcp_points(16, 1, where).astype(np.float32)
    u = np.random.default_rng(2).standard_normal((16, D)).astype(np.float32)
    score = score_for_target(load_target("lgcp", _config(use_whitened=whitened), device="cpu"))
    assert isinstance(score, LgcpScore) and score.whitened == whitened and score.dim == D
    grad_t = _jax_score_t(whitened)
    z_t, u_t = jnp.asarray(z.T), jnp.asarray(u.T)
    want, vjp = jax.vjp(grad_t, z_t)
    want, want_h = np.asarray(want).T, np.asarray(vjp(u_t)[0]).T
    got = score(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    got_h = score.hvp(torch.from_numpy(z), torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got_h, want_h, rtol=0, atol=1e-5 * np.abs(want_h).max())


@pytest.mark.parametrize("whitened", [False, True])
def test_lgcp_score_and_hvp_match_float64_autograd(whitened):
    """In float64 against autograd of the port's log-density (one and two
    derivatives), at both kinds of points. The unwhitened log-density reads
    L^{-1} in float32 and the score Sigma^{-1} = L^{-T} L^{-1} formed in
    float64 and then cast: the two matrices differ in their last bits, so the
    unwhitened score is held to 1e-6 of the largest entry, the whitened one
    (the same L in both) to 1e-10."""
    target = load_target("lgcp", _config(use_whitened=whitened), device="cpu")
    score = score_for_target(target)
    tol = 1e-10 if whitened else 1e-6
    for where in ("init", "moved"):
        z = torch.from_numpy(lgcp_points(8, 3, where)).requires_grad_(True)
        u = torch.from_numpy(np.random.default_rng(4).standard_normal((8, D)))
        (g,) = torch.autograd.grad(target.log_prob(z).sum(), z, create_graph=True)
        (h,) = torch.autograd.grad(g, z, u)
        got, got_h = score(z.detach()), score.hvp(z.detach(), u)
        assert got.dtype == torch.float64
        assert float((got - g).abs().max()) <= tol * float(g.abs().max())
        assert float((got_h - h).abs().max()) <= tol * float(h.abs().max())


def test_score_for_target_builds_nothing_per_call():
    """The constants are the target's: two calls wrap the same tensors; the
    kernels read [mu, a] as the target floats; a custom CSV or grid has no
    kernel score (as JAX's _build_lgcp)."""
    target = load_target("lgcp", device="cpu")
    a, b = score_for_target(target), score_for_target(target, "cpu")
    assert a.mat is b.mat is target.constants["prec"] and a.counts is b.counts
    w = load_target("lgcp", _config(use_whitened=True), device="cpu")
    assert score_for_target(w).mat is w.constants["chol"]
    code, tpar, _ = kernel_target(a, "cpu")
    assert code == TARGETS["lgcp"] == 4 and TARGETS["lgcp_whitened"] == 5
    assert tpar.tolist() == pytest.approx([MU, 1.0 / D])
    assert make_many_gmm_score("cpu") is make_many_gmm_score("cpu")
    custom = load_target("lgcp", _config(file_path=JAX_DATA), device="cpu")
    assert custom.params["default_data"] is False and score_for_target(custom) is None
    small = tlgcp.make_lgcp(num_dim=400, device="cpu")
    assert score_for_target(small) is None and lgcp_score(small).dim == 400
    assert grad_t_for_target(jlgcp.make_lgcp(file_path=JAX_DATA), 1600) is not None


def make_case(n=4, k=2, whitened=False, eps=1e-3, mean=0.0, train_eps=True):
    """One MCD_CAIS_sn LGCP problem in both packages: eps, vd and the beta
    knots trainable, non-uniform knots, a variational mean at `mean`, the
    net with factor_sn 0.3, a random head and embedding so that every part
    of its VJP and its row clamp are live."""
    cfg = _config(use_whitened=whitened)
    jt = cmcd_tpu.load_target("lgcp", cfg)
    kw = dict(mode="MCD_CAIS_sn", dim=D, nbridges=k, emb_dim=EMB)
    jsetup = jb.CMCDSetup(**kw)
    trainable = jb.default_trainable("MCD_CAIS_sn", train_eps=train_eps, train_vi=True)
    params, jctx = jb.initialize(jsetup, jt.log_prob, eps=eps, init_sigma=1.0,
                                 trainable=trainable)
    sn = params["train"]["sn"]
    sn["factor_sn"] = jnp.asarray(0.3)
    sn["head"]["w"] = 0.05 * jax.random.normal(jax.random.PRNGKey(9), sn["head"]["w"].shape)
    sn["emb"] = jax.random.normal(jax.random.PRNGKey(8), sn["emb"].shape)
    params["train"]["mgridref_y"] = jax.random.uniform(
        jax.random.PRNGKey(4), params["train"]["mgridref_y"].shape, minval=0.5, maxval=1.5)
    params["train"]["vd"]["mean"] = jnp.full((D,), mean, jnp.float32)
    rng = np.random.default_rng(2)
    base = rng.standard_normal((n, D)).astype(np.float32)
    noise = rng.standard_normal((k, n, D)).astype(np.float32)
    target = load_target("lgcp", cfg, device="cpu")
    tsetup = tb.CMCDSetup(**kw)
    _, tctx = tb.initialize(tsetup, target.log_prob, device="cpu")
    return {
        "jt": jt, "jsetup": jsetup, "jparams": params, "jctx": jctx,
        "key": jax.random.PRNGKey(0), "jnoise": jnp.asarray(noise), "jbase": jnp.asarray(base),
        "n": n, "k": k, "rng": rng, "target": target, "setup": tsetup, "ctx": tctx,
        "trainable": trainable, "params": params_from_jax(jax.device_get(params), device="cpu"),
        "draws": {"base_normals": torch.from_numpy(base), "noise": torch.from_numpy(noise)},
    }


def torch_value_and_grad(case, loss_fn):
    train_tree = case["params"]["train"]
    leaves = [train_tree[k] for k in ("eps", "mgridref_y") if k in train_tree]
    leaves += [*train_tree["vd"].values(), *train_tree["sn"].parameters()]
    for leaf in leaves:
        leaf.requires_grad_(True)
        leaf.grad = None
    loss, _ = loss_fn(case["params"], case["n"], case["ctx"], case["setup"], **case["draws"])
    loss.backward()
    return float(loss.detach()), grads_to_numpy(train_tree)


def jax_scan_loss(case):
    def loss(train_tree):
        p = jb.merged_params({"train": train_tree, "notrain": case["jparams"]["notrain"]})
        z = p["vd"]["mean"] + jnp.exp(p["vd"]["logdiag"]) * case["jbase"]
        w = -j_log_prob(p["vd"], z)
        betas = j_betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])
        z, wd, _ = jod.evolve_overdamped(case["key"], z, betas, p, case["jctx"], jod.CAIS,
                                         noise=case["jnoise"])
        return jnp.mean(-(w + wd + case["jctx"].target_log_prob(z)))

    return loss


def float64_grads(whitened):
    """The eager kl_bound's gradient in float64 (a float64 copy of the
    case's parameters and draws; the target's constants cast at each use),
    the arbiter of two float32 orders."""
    case = make_case(whitened=whitened)
    case["params"] = double_tree(case["params"])
    case["draws"] = {k: v.double() for k, v in case["draws"].items()}
    return torch_value_and_grad(case, tb.kl_bound)[1]


def assert_grads_close_arbitrated(got, want, ref, rel=2e-4, floor=1e-4):
    """assert_grads_close leaf by leaf, except that a leaf beyond rel |want|
    + floor passes if it is no farther from the float64 gradient `ref` than F64_SLACK
    times JAX's float32 one is: the eps leaf at D = 1600 sums 1600 x K
    residual terms of size 1/eps that cancel to a few 1e-4 in float32, in
    either package's order."""
    got_l, tree_g = jax.tree_util.tree_flatten(got)
    want_l, tree_w = jax.tree_util.tree_flatten(jax.device_get(want))
    ref_l, tree_r = jax.tree_util.tree_flatten(ref)
    assert tree_g == tree_w == tree_r
    for g, w, r in zip(got_l, want_l, ref_l):
        g, w, r = (np.asarray(x, np.float64).ravel() for x in (g, w, r))
        if np.linalg.norm(g - w) < rel * np.linalg.norm(w) + floor:
            continue
        assert np.linalg.norm(g - r) <= F64_SLACK * np.linalg.norm(w - r), (g, w, r)
    flat = np.concatenate([np.asarray(x, np.float64).ravel() for x in want_l])
    assert np.linalg.norm(flat) > 1.0  # a live gradient, not zeros against zeros


F64_SLACK = 4.0


@pytest.mark.parametrize("whitened", [False, True])
def test_eager_kl_bound_and_fused_loss_match_jax_scan(whitened):
    """The eager kl_bound (autograd through the port's integrator) and the
    fused loss (the plain wide rollout and the plain split sweep) against
    JAX's scan loss: the loss and every leaf, at N=4, K=2, emb 20, with the
    float64 eager gradient arbitrating a leaf beyond the limit."""
    case = make_case(whitened=whitened)
    ref = float64_grads(whitened)
    want_l, want_g = jax.value_and_grad(jax_scan_loss(case))(case["jparams"]["train"])
    got_l, got_g = torch_value_and_grad(case, tb.kl_bound)
    np.testing.assert_allclose(got_l, float(want_l), rtol=1e-4)
    assert_grads_close_arbitrated(got_g, want_g, ref)
    before = (evolve_overdamped_wide.launches, evolve_kl_split.launches)
    fused = lambda p, n_, c, s, **d: kl_bound_fused(p, n_, c, s, case["target"], **d)
    got_l, got_g = torch_value_and_grad(case, fused)
    assert (evolve_overdamped_wide.launches, evolve_kl_split.launches) == before
    np.testing.assert_allclose(got_l, float(want_l), rtol=1e-4)
    assert_grads_close_arbitrated(got_g, want_g, ref)
    assert np.linalg.norm(got_g["sn"]["factor_sn"]) > 0 and np.linalg.norm(got_g["eps"]) > 0


def _port_rollout(case, whitened):
    p = tb.merged_params(case["params"])
    betas = betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"]).detach()
    z0 = (p["vd"]["mean"] + torch.exp(p["vd"]["logdiag"]) * case["draws"]["base_normals"]).detach()
    args = (betas, p["eps"].detach(), p["vd"]["mean"].detach(), p["vd"]["logdiag"].detach(),
            score_for_target(case["target"]), tod.CAIS)
    kw = dict(dim=D, nbridges=case["k"], sn=p["sn"])
    return z0, args, kw


@pytest.mark.parametrize("whitened,mean", [(False, 0.0), (True, 0.0), (False, MU)])
def test_plain_wide_rollout_matches_jax_scan(whitened, mean):
    """The wide rollout's plain twin (the wrapper on CPU tensors) against
    JAX's scan integrator, at init and at a variational mean on mu."""
    case = make_case(whitened=whitened, mean=mean)
    p = jb.merged_params(case["jparams"])
    z0_j = p["vd"]["mean"] + jnp.exp(p["vd"]["logdiag"]) * case["jbase"]
    betas_j = j_betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])
    z_j, w_j, _ = jod.evolve_overdamped(case["key"], z0_j, betas_j, p, case["jctx"], jod.CAIS,
                                        noise=case["jnoise"])
    z0, args, kw = _port_rollout(case, whitened)
    before = evolve_overdamped_wide.launches
    z, w, traj, noise = evolve_overdamped_wide(z0, torch.zeros(case["n"]), *args,
                                               noise=case["draws"]["noise"],
                                               return_trajectory=True, return_noise=True, **kw)
    assert evolve_overdamped_wide.launches == before  # no kernel on a CPU tensor
    assert traj.shape == (3, 4, D) and noise is case["draws"]["noise"]
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=2e-2, rtol=0)
    assert float(np.abs(np.asarray(w_j)).max()) > 1.0


def test_plain_wide_rollout_matches_jax_pallas_rollout():
    """Against JAX's fused rollout (B1) at D = 1600 in interpret mode, the
    form tests/test_pallas.py:289 holds against the scan: z, w and the
    stored trajectory."""
    case = make_case(n=4, k=2)
    p = jb.merged_params(case["jparams"])
    dim_pad = _dim_pad(D)
    z0_j = p["vd"]["mean"] + jnp.exp(p["vd"]["logdiag"]) * case["jbase"]
    betas_j = j_betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])
    sn_w, sn_meta = pack_geffner_t(p["sn"], D, dim_pad)
    z_j, w_j, traj_t = evolve_overdamped_pallas(
        z0_j, jnp.zeros(case["n"]), betas_j, p["eps"], p["vd"]["mean"], p["vd"]["logdiag"],
        grad_t_for_target(case["jt"], dim_pad), jod.CAIS, dim=D, nbridges=case["k"],
        sn_weights=sn_w, sn_meta=sn_meta, noise=case["jnoise"], return_trajectory_t=True,
        block=128, interpret=True)
    z0, args, kw = _port_rollout(case, False)
    z, w, traj = evolve_overdamped_wide(z0, torch.zeros(case["n"]), *args,
                                        noise=case["draws"]["noise"], return_trajectory=True,
                                        **kw)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=2e-2, rtol=0)
    want = np.asarray(traj_t)[:, :D, :case["n"]].transpose(0, 2, 1)
    np.testing.assert_allclose(traj.numpy(), want, atol=1e-5, rtol=0)


def test_plain_split_sweep_matches_jax_split_kernel():
    """The split sweep's plain version against JAX's split Pallas sweep
    (net_grads_outside: z-sweep in the kernel, the weights' gradients from
    one batched vjp) in interpret mode, at many_gmm's size, as
    tests/test_pallas_kl.py:113 runs it: every small leaf, every net leaf
    (factor_sn 0.3, so a cotangent taken on the wrong side of the factor
    fails, and K = 5 embedding rows, so an unclamped point K fails) and
    dL/dz0."""
    case = many_gmm_case("cos_sq", True)
    n = case["n"]
    traj_t, noise_t, j_args, j_kw = _jax_forward(case)
    cot = case["rng"].standard_normal(n).astype(np.float32)
    g_zfinal = case["rng"].standard_normal((n, 2)).astype(np.float32)
    want, want_z0 = evolve_kl_bwd_pallas(
        traj_t, noise_t, jnp.asarray(cot), jnp.asarray(g_zfinal), *j_args, n_chains=n,
        net_grads_outside=True, **j_kw)
    traj = torch.from_numpy(np.ascontiguousarray(np.asarray(traj_t)[:, :2, :n].transpose(0, 2, 1)))
    args, kw = _port_args(case)
    got, got_z0, gsn = evolve_kl_split_plain(traj, case["draws"]["noise"], torch.from_numpy(cot),
                                             torch.from_numpy(g_zfinal), *args, **kw)
    assert gsn.shape == (case["k"] + 1, n, 2)
    assert_grads_close(_to_jax_layout(case, got), jax.device_get(want), rel=2e-4)
    want_z0 = np.asarray(want_z0)
    assert np.linalg.norm(got_z0.numpy() - want_z0) < 2e-4 * np.linalg.norm(want_z0) + 1e-4


def test_split_sweep_weight_grads_equal_the_carry_sweep():
    """In float64, the split sweep's gradients (the z-sweep, then one
    batched weight pass seeded with gsn) equal the carry sweep's (weights
    differentiated point by point inside the sweep) to 1e-10: the seed is
    the cotangent of the net's output with factor_sn applied, point K takes
    embedding row K - 1. Each of the two faults moves some leaf by more
    than 1e-3 of its norm."""
    case = many_gmm_case("cos_sq", True)
    args, kw = _port_args(case)
    z0 = 8.0 * case["draws"]["base_normals"]
    _, _, traj, noise = evolve_overdamped_fused(
        z0, torch.zeros(case["n"]), *args, noise=case["draws"]["noise"], return_trajectory=True,
        return_noise=True, **kw)
    traj, noise = traj.double(), noise.double()
    cot = torch.from_numpy(case["rng"].standard_normal(case["n"]))
    g_zf = torch.from_numpy(case["rng"].standard_normal((case["n"], 2)))
    carry, z_carry = evolve_kl_bwd_plain(traj, noise, cot, g_zf, *args, **kw)
    split, z_split, gsn = evolve_kl_split_plain(traj, noise, cot, g_zf, *args, **kw)
    assert torch.allclose(z_split, z_carry, rtol=1e-10, atol=1e-12)
    for name in ("eps", "betas", "vd_mean", "vd_logdiag"):
        assert torch.allclose(split[name], carry[name], rtol=1e-10, atol=1e-12), name
    assert set(split["sn"]) == set(carry["sn"])
    for name, g in carry["sn"].items():
        assert float((split["sn"][name] - g).norm()) <= 1e-10 * float(g.norm()) + 1e-12, name
    sn, k = kw["sn"], case["k"]
    # The faults: the seed taken before the factor, point K at row K.
    bad_seed = kl_split.net_weight_grads(sn, traj, gsn / float(sn.factor_sn), k)
    assert float((bad_seed["head.weight"] - carry["sn"]["head.weight"]).norm()) > 1e-3 * float(
        carry["sn"]["head.weight"].norm())
    g_bad = _weight_grads_at_rows(sn, traj, gsn, torch.arange(k + 1) % k)  # point K at row 0
    assert float((g_bad["emb"] - carry["sn"]["emb"]).norm()) > 1e-3 * float(
        carry["sn"]["emb"].norm())


def _weight_grads_at_rows(sn, traj, gsn, rows):
    from cmcd_tpu_torch.ops import nets

    weights = nets.plain_weights(sn, traj.shape[0] - 1, traj.dtype, traj.device)
    with torch.enable_grad():
        out = nets.geffner_from_weights(weights, traj, rows)
        grads = torch.autograd.grad(out, list(weights.values()), gsn)
    return dict(zip(weights, grads))


STEPS = 5


def test_five_lgcp_k8_steps_match_the_jax_trainer():
    """lgcp_k8's flags (MCD_CAIS_sn, emb 20, lr 1e-4, eps and vd trained)
    cut to N=8, K=2 and no MFVI, in both packages' trainers under the same
    draws, the fused KL loss (plain wide rollout and split sweep) on the
    port's side: losses and every parameter after five Adam steps. eps
    starts at 1e-3, not the recipe's 1e-5: there the eps gradient is a sum
    of 1/eps-sized terms that float32 gets to only ~1e-2 in either package
    (float64 -529.2, JAX -511.0, the port -532.7 at this case), so after
    Adam's first step (+lr = 1e-4, ten times eps) its sign is rounding and
    the two trainers' eps part ways; at 1e-3 float32 holds it to 1e-3."""
    case = make_case(n=8, k=2, eps=1e-3, mean=MU)
    n, k = case["n"], case["k"]
    rng = np.random.default_rng(11)
    draws = [(rng.standard_normal((n, D)).astype(np.float32),
              rng.standard_normal((k, n, D)).astype(np.float32)) for _ in range(STEPS)]
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
    want = jtrainer.train(case["jsetup"], case["jparams"], case["jctx"], lr=1e-4, iters=STEPS,
                          batch_size=n, key=jax.random.PRNGKey(0), trainable=trainable,
                          loss_fn=j_loss, log_every=1, steps_per_call=1)
    step = {"i": 0}

    def loss_fn(params, n_, ctx, setup, generator=None):
        base, noise = draws[step["i"]]
        step["i"] += 1
        return kl_bound_fused(params, n_, ctx, setup, case["target"],
                              base_normals=torch.from_numpy(base), noise=torch.from_numpy(noise))

    got = train(case["setup"], case["params"], case["ctx"], lr=1e-4, iters=STEPS,
                batch_size=n, trainable=trainable, loss_fn=loss_fn, log_every=1)
    assert got.steps_done == STEPS and not got.diverged and not bool(want.diverged)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses), rtol=1e-4)
    got_l, treedef = jax.tree_util.tree_flatten(params_to_numpy(got.params["train"]))
    want_l, want_def = jax.tree_util.tree_flatten(jax.device_get(want.params["train"]))
    assert treedef == want_def
    for g, w in zip(got_l, want_l):
        assert np.linalg.norm(g - w) <= 2e-4 * np.linalg.norm(w) + 1e-7


LGCP_CLI = ("--config.model lgcp --config.boundmode MCD_CAIS_sn --config.N 8 "
            "--config.nbridges 8 --config.emb_dim 20 --config.mfvi_iters 20 "
            "--config.iters 5 --config.n_samples 8 --config.n_input_dist_seeds 2 "
            "--config.log.every 1").split()


@pytest.mark.parametrize("whitened", [False, True])
def test_cli_runs_lgcp_on_cpu(whitened, tmp_path, monkeypatch, capsys):
    """lgcp_k8's flags cut to N=8, 20 MFVI and 5 training iterations and a
    2 x 8 evaluation through the CLI on the CPU: LR_DICT sets lr 1e-4; the
    fused KL loss takes the wide rollout and the split sweep (their plain
    versions), the evaluation the wide rollout, and no other kernel's
    wrapper (test_torch_ula.OTHER_WRAPPERS, the tile rollout and sweep) is
    called."""
    def refuse(name):
        def fn(*a, **k):
            raise AssertionError(f"the LGCP path called {name}")
        return fn

    real = (overdamped_wide.evolve_overdamped_wide, kl_split.evolve_kl_split)
    for module, names in OTHER_WRAPPERS.items():
        for name in names:
            monkeypatch.setattr(module, name, refuse(name))
    monkeypatch.setattr(overdamped, "evolve_overdamped_fused", refuse("evolve_overdamped_fused"))
    monkeypatch.setattr(fused_train, "evolve_overdamped_fused",
                        refuse("evolve_overdamped_fused"))
    monkeypatch.setattr(fused_train, "evolve_kl_bwd", refuse("evolve_kl_bwd"))
    calls = {"rollout": 0, "sweep": 0}

    def spy(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            assert a[0].shape[-1] == D
            return fn(*a, **k)
        return wrapped

    rollout = spy("rollout", real[0])
    monkeypatch.setattr(overdamped_wide, "evolve_overdamped_wide", rollout)
    monkeypatch.setattr(fused_train, "evolve_overdamped_wide", rollout)
    monkeypatch.setattr(fused_train, "evolve_kl_split", spy("sweep", real[1]))
    log = tmp_path / "lgcp.jsonl"
    flags = LGCP_CLI + ["--config.log.jsonl", str(log), "--config.use_whitened", str(whitened)]
    cfg = parse_flags(flags)
    out = run_experiment(cfg, device="cpu")
    printed = capsys.readouterr().out
    assert "kl_bound_fused, wide rollout and split KL reverse sweep (B12)" in printed
    assert "Done training initial parameters" in printed
    assert cfg.lr == 1e-4 and cfg.use_whitened == whitened
    assert calls == {"rollout": 5 + 2, "sweep": 5}
    result = out["train"]
    assert result.steps_done == 5 and not result.diverged
    assert torch.isfinite(result.losses).all()
    assert np.isfinite(out["final_elbo"]) and out["neg_elbos"].shape == (2, 8)
    assert out["samples"].shape == (2 * 8, D)
    assert log_summary.summarise(str(log))["final_elbo"] == out["final_elbo"]


def test_refusals_before_any_launch():
    """Only MCD_CAIS_sn with the two-layer geffner net takes the LGCP's
    kernels; every other mode, a PIS net, a custom data file and another
    grid are refused by the gates, and the wrappers raise on a target or a
    spec their kernel does not take, on either device, before a launch."""
    target = load_target("lgcp", device="cpu")
    ok = tb.CMCDSetup(mode="MCD_CAIS_sn", dim=D, nbridges=8, emb_dim=EMB)
    assert supports_fused(ok, target) and supports_fused_train(ok, target)
    assert fused_training_path(ok, 20)[1] == \
        "kl_bound_fused, wide rollout and split KL reverse sweep (B12)"
    assert net_bytes(ok) == 4 * (2 * (1620 * 1620 + 1620) + 1600 * 1621 + 8 * 20 + 1)
    for mode in ("MCD_CAIS_var_sn", "MCD_ULA_sn", "MCD_ULA", "MCD_U_a-lp", "MCD_U_a-lp-sn",
                 "MCD_U_e-lp", "MCD_U_ea-lp-sn", "MCD_CAIS_UHA_sn", "UHA", "MCD_DNF"):
        setup = tb.CMCDSetup(mode=mode, dim=D, nbridges=8, emb_dim=EMB)
        assert not supports_fused(setup, target) and not supports_fused_train(setup, target)
    for arch in ("dds", "dds_grad"):
        setup = tb.CMCDSetup(mode="MCD_CAIS_sn", dim=D, nbridges=8, nn_arch=arch,
                             fully_connected_units=(64, 64))
        assert not supports_fused(setup, target)
    custom = load_target("lgcp", _config(file_path=JAX_DATA), device="cpu")
    assert not supports_fused(ok, custom) and not supports_fused_train(ok, custom)
    small = tlgcp.make_lgcp(num_dim=400, device="cpu")
    assert not supports_fused(tb.CMCDSetup(mode="MCD_CAIS_sn", dim=400, nbridges=8), small)
    score = score_for_target(target)
    sn = tb.initialize(ok, target.log_prob, device="cpu")[0]["train"]["sn"]
    z, w0, betas, vd = torch.zeros(4, D), torch.zeros(4), torch.ones(8), torch.zeros(D)
    before = (evolve_overdamped_fused.launches, evolve_overdamped_wide.launches)
    with pytest.raises(NotImplementedError, match="wide forms"):
        evolve_overdamped_fused(z, w0, betas, 1e-5, vd, vd, score, tod.ULA, dim=D, nbridges=8)
    for spec in (tod.ULA, tod.ULA_SN):
        with pytest.raises(NotImplementedError, match="no kernel"):
            evolve_overdamped_wide(z, w0, betas, 1e-5, vd, vd, score, spec, dim=D, nbridges=8,
                                   sn=sn)
    with pytest.raises(NotImplementedError, match="LGCP score only"):
        evolve_overdamped_wide(torch.zeros(4, 2), w0, betas, 0.1, vd[:2], vd[:2],
                               make_many_gmm_score("cpu"), tod.CAIS, dim=2, nbridges=8, sn=sn)
    with pytest.raises(NotImplementedError, match="no kernel"):
        evolve_kl_split(torch.zeros(9, 4, D), torch.zeros(8, 4, D), w0, z, betas, 1e-5, vd, vd,
                        score, tod.ULA_SN, dim=D, nbridges=8, sn=sn)
    assert (evolve_overdamped_fused.launches, evolve_overdamped_wide.launches) == before


def test_wide_host_layout():
    """The formulas the wrappers hold against the kernels' (ops/*._library)
    at LGCP's widths: the rollout block's shared memory (4 staging rows of
    1620 floats and 16 warps x 8 sums) and a chain's workspace (8 x 1600 +
    2 x 1620 floats), and the split sweep's sums."""
    assert overdamped_wide.smem_bytes(1620, 1600) == 4 * (4 * 1620 + 16 * 8)
    assert overdamped_wide.ws_floats(overdamped_wide.ROLLOUT_WS, 1620, 1600) == 16040
    assert kl_split.len_sums(1600, 8) == 3209
    assert overdamped_wide.kernel_fits(1620, 2, 1600)
    assert not overdamped_wide.kernel_fits(1618, 2, 1600)   # widths a multiple of 4
    assert not overdamped_wide.kernel_fits(1620, 80, 1600)  # the LGCP's two floats
    assert overdamped_wide.kernel_fits(84, 2, 64) and not overdamped_wide.kernel_fits(22, 2, 2)


@pytest.mark.parametrize("dim, k, want", [(1600, 8, 3209), (4, 1, 10), (64, 3, 132),
                                          (1600, 256, 3457)])
def test_split_sweep_len_sums(dim, k, want):
    """The sweep's output: d eps0, d betas (K), d vd_mean and d vd_logdiag."""
    assert kl_split.len_sums(dim, k) == want


def test_geffner_from_jax_at_x_dim_1600():
    """utils/convert.geffner_from_jax at LGCP's width: the JAX net's apply
    and the port's agree on the same points and rows, the last row
    clamped."""
    jsetup = jb.CMCDSetup(mode="MCD_CAIS_sn", dim=D, nbridges=8, emb_dim=EMB)
    params, _ = jb.initialize(jsetup, lambda z: -0.5 * jnp.sum(z * z, -1), eps=0.1)
    sn = params["train"]["sn"]
    sn["factor_sn"] = jnp.asarray(0.7)
    sn["emb"] = jax.random.normal(jax.random.PRNGKey(1), sn["emb"].shape)
    net = geffner_from_jax(jax.device_get(sn), device="cpu")
    assert (net.x_dim, net.emb_dim, net.in_dim, net.nbridges) == (D, EMB, 1620, 8)
    from cmcd_tpu.networks.geffner import build_geffner_network

    _, apply_fn = build_geffner_network(D, EMB, 8)  # (init_fn, apply_fn)
    z = np.random.default_rng(5).standard_normal((4, D)).astype(np.float32)
    for i in (0, 7, 8):
        want = np.asarray(apply_fn(sn, jnp.asarray(z), i))
        got = net(torch.from_numpy(z), i).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
