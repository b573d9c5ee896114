"""The port's trainer pieces against the JAX package, on the CPU: the
projection, clip-then-Adam against optax on the same numpy gradients, EMA,
the NaN guard's asymmetry, the steps_per_call rule, unused leaves, the
callback's keys and MFVI pretraining."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cmcd_tpu.train import trainer as jtrainer
from cmcd_tpu_torch import bounds as tb
from cmcd_tpu_torch.targets import load_target
from cmcd_tpu_torch.train import create_optimizer, mfvi_pretrain, project, train
from cmcd_tpu_torch.train.trainer import tree_leaves

torch.set_num_threads(1)


def test_project_matches_jax_on_all_four_keys():
    tree = {"eps": np.float32(0.7), "eta": np.float32(-0.2), "gamma": np.float32(1e-5),
            "mgridref_y": np.array([-1.0, 0.0005, 0.001, 0.5, 2.0], np.float32),
            "vd": {"mean": np.array([3.0, -4.0], np.float32)}}
    keys = ("eps", "eta", "gamma", "mgridref_y")
    want = jtrainer.project({k: jnp.asarray(v) if k != "vd" else v for k, v in tree.items()}, keys)
    got = project({k: torch.from_numpy(np.asarray(v)) if k != "vd"
                   else {"mean": torch.from_numpy(v["mean"])} for k, v in tree.items()}, keys)
    for k in keys:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert [float(got[k]) for k in ("eps", "eta", "gamma")] == pytest.approx([0.5, 0.0, 0.001])
    np.testing.assert_array_equal(got["vd"]["mean"].numpy(), tree["vd"]["mean"])
    low = project({"eps": torch.tensor(0.0), "eta": torch.tensor(1.5)}, keys)
    assert float(low["eps"]) == pytest.approx(1e-7) and float(low["eta"]) == pytest.approx(0.99)


def test_clip_then_adam_matches_optax():
    """Five steps on the same numpy gradients, elements beyond +-5 among
    them: an elementwise clip, not a norm clip."""
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 3), "b": (5,), "c": ()}
    values = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 4.0).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    grads[0]["a"][0, 0], grads[1]["b"][2], grads[2]["c"] = 80.0, -33.0, np.float32(9.0)
    assert max(np.abs(g[k]).max() for g in grads for k in shapes) > 5.0

    lr = 0.005
    opt = jtrainer.create_optimizer(lr)
    jp = {k: jnp.asarray(v) for k, v in values.items()}
    state = opt.init(jp)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in values.items()}
    leaves = [tp[k] for k in sorted(tp)]
    topt = create_optimizer(leaves, lr)
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        topt.step([torch.from_numpy(np.asarray(g[k])) for k in sorted(tp)])
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=k)
    # The first step moves every element by lr (Adam's unit first step),
    # also the one whose gradient was 80: a norm clip would have shrunk the rest.
    first = create_optimizer([torch.zeros(3)], lr)
    first.step([torch.tensor([80.0, 0.5, -2.0])])
    np.testing.assert_allclose(first.leaves[0].numpy(), [-lr, -lr, lr], rtol=1e-4)


def _quadratic_problem(device="cpu"):
    """A bound-shaped toy: params as initialize builds them for a net-free
    mode, and a loss_fn the tests replace."""
    target = load_target("many_gmm", device=device)
    setup = tb.CMCDSetup(mode="MCD_ULA", dim=2, nbridges=4)
    trainable = tb.default_trainable(setup.mode)
    params, ctx = tb.initialize(setup, target.log_prob, eps=0.1, trainable=trainable,
                                init_sigma=3.0, device=device)
    return setup, params, ctx, trainable


def _loss_on_vd(scale=1.0):
    def loss_fn(params, n, ctx, setup, generator=None):
        vd = params["train"]["vd"]
        loss = scale * (torch.sum((vd["mean"] - 1.0) ** 2) + torch.sum(vd["logdiag"] ** 2))
        return loss, (torch.zeros(n), torch.zeros(n, 2))
    return loss_fn


def test_train_leaves_the_input_alone_and_survives_unused_leaves():
    setup, params, ctx, trainable = _quadratic_problem()
    before = {k: v.clone() for k, v in params["train"]["vd"].items()}
    res = train(setup, params, ctx, lr=0.05, iters=40, batch_size=4, trainable=trainable,
                loss_fn=_loss_on_vd())
    assert not res.diverged and res.steps_done == 40
    for k, v in before.items():  # the caller's tree is untouched
        assert torch.equal(params["train"]["vd"][k], v)
    # eta, gamma, eps, mgridref_y are trainable and unused by this loss: no
    # gradient, no failure, no movement.
    for k in ("eta", "gamma", "eps", "mgridref_y"):
        assert torch.equal(res.params["train"][k], params["train"][k]), k
    assert float(res.params["train"]["vd"]["mean"][0]) > 0.5
    assert res.losses[-1] < res.losses[0]
    assert not any(leaf.requires_grad for leaf in tree_leaves(res.params["train"]))


def test_ema_is_an_incremental_update():
    """ema_t = step * p_t + (1 - step) * ema_{t-1} from ema_0 = p_0, as
    optax.incremental_update."""
    setup, params, ctx, trainable = _quadratic_problem()
    kw = dict(lr=0.05, batch_size=4, trainable=trainable, loss_fn=_loss_on_vd())
    res = train(setup, params, ctx, iters=3, use_ema=True, ema_step_size=0.25, **kw)
    ema = params["train"]["vd"]["mean"].clone()
    for t in range(1, 4):
        p_t = train(setup, params, ctx, iters=t, **kw).params["train"]["vd"]["mean"]
        ema = 0.25 * p_t + 0.75 * ema
    np.testing.assert_allclose(res.ema_params["train"]["vd"]["mean"].numpy(), ema.numpy(),
                               rtol=1e-5)
    assert not torch.equal(res.ema_params["train"]["vd"]["mean"],
                           res.params["train"]["vd"]["mean"])
    assert train(setup, params, ctx, iters=3, **kw).ema_params is None


class _ZeroWithNanGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.sum() * 0.0

    @staticmethod
    def backward(ctx, g):
        return torch.full((2,), math.nan)


def _loss_with_fault(kind, at):
    """The vd loss, with a fault from step `at` on: an inf loss value (finite
    gradient), a NaN loss value, or a finite loss whose gradient makes a
    parameter NaN."""
    count = {"i": 0}
    base = _loss_on_vd()

    def loss_fn(params, n, ctx, setup, generator=None):
        loss, aux = base(params, n, ctx, setup)
        i = count["i"]
        count["i"] += 1
        if i >= at:
            if kind == "inf":
                loss = loss + torch.tensor(math.inf)
            elif kind == "nan":
                loss = loss + torch.tensor(math.nan)
            elif kind == "param":
                loss = loss + _ZeroWithNanGradient.apply(params["train"]["vd"]["mean"])
        return loss, aux

    return loss_fn


@pytest.mark.parametrize("kind", ["inf", "nan", "param"])
def test_nan_guard_asymmetry_matches_jax(kind):
    """An inf loss trains on; a NaN loss or a non-finite parameter stops the
    run at the failing chunk's start with the last finite parameters."""
    setup, params, ctx, trainable = _quadratic_problem()
    res = train(setup, params, ctx, lr=0.05, iters=40, batch_size=4, trainable=trainable,
                loss_fn=_loss_with_fault(kind, at=25), steps_per_call=10, nan_check_every=10)
    clean20 = train(setup, params, ctx, lr=0.05, iters=20, batch_size=4, trainable=trainable,
                    loss_fn=_loss_on_vd(), steps_per_call=10, nan_check_every=10)
    if kind == "inf":
        clean40 = train(setup, params, ctx, lr=0.05, iters=40, batch_size=4,
                        trainable=trainable, loss_fn=_loss_on_vd(), steps_per_call=10)
        assert not res.diverged and res.steps_done == 40
        assert torch.isinf(res.losses).any()
        for a, b in zip(tree_leaves(res.params["train"]), tree_leaves(clean40.params["train"])):
            assert torch.equal(a, b)
    else:
        # The JAX trainer sets steps_done to the failing chunk's start (20)
        # and returns the parameters of the last check that passed.
        assert res.diverged and res.steps_done == 20
        for a, b in zip(tree_leaves(res.params["train"]), tree_leaves(clean20.params["train"])):
            assert torch.equal(a, b) and torch.isfinite(a).all()


def test_nan_guard_steps_done_is_jax_rule():
    """The same run in the JAX trainer: diverged, steps_done 20."""
    import cmcd_tpu
    from cmcd_tpu import bounds as jb

    jt = cmcd_tpu.load_target("many_gmm")
    jsetup = jb.CMCDSetup(mode="MCD_ULA", dim=2, nbridges=4)
    trainable = jb.default_trainable(jsetup.mode)
    params, ctx = jb.initialize(jsetup, jt.log_prob, eps=0.1, trainable=trainable)

    def loss_fn(full, key, n, ctx, setup):
        vd = full["train"]["vd"]
        loss = jnp.sum((vd["mean"] - 1.0) ** 2) + jnp.sum(vd["logdiag"] ** 2)
        # Adam's bounded steps carry mean[0] past 0.6 between steps 20 and 30.
        loss = jnp.where(vd["mean"][0] > 0.6, jnp.nan, loss)
        return loss, (jnp.zeros(n), jnp.zeros((n, 2)))

    res = jtrainer.train(jsetup, params, ctx, lr=0.025, iters=40, batch_size=4,
                         key=jax.random.PRNGKey(0), trainable=trainable, loss_fn=loss_fn,
                         steps_per_call=10, nan_check_every=10)

    setup, tparams, tctx, ttrainable = _quadratic_problem()
    with torch.no_grad():
        tparams["train"]["vd"]["logdiag"].zero_()

    def t_loss_fn(p, n, ctx, setup, generator=None):
        vd = p["train"]["vd"]
        loss = torch.sum((vd["mean"] - 1.0) ** 2) + torch.sum(vd["logdiag"] ** 2)
        loss = torch.where(vd["mean"][0] > 0.6, torch.tensor(math.nan), loss)
        return loss, (torch.zeros(n), torch.zeros(n, 2))

    got = train(setup, tparams, tctx, lr=0.025, iters=40, batch_size=4, trainable=ttrainable,
                loss_fn=t_loss_fn, steps_per_call=10, nan_check_every=10)
    assert bool(res.diverged) and got.diverged
    assert got.steps_done == res.steps_done
    np.testing.assert_allclose(got.params["train"]["vd"]["mean"].numpy(),
                               np.asarray(res.params["train"]["vd"]["mean"]), rtol=1e-5)


def test_steps_per_call_must_divide_iters():
    setup, params, ctx, trainable = _quadratic_problem()
    with pytest.raises(ValueError, match="must divide"):
        train(setup, params, ctx, lr=0.05, iters=10, batch_size=4, trainable=trainable,
              loss_fn=_loss_on_vd(), steps_per_call=3)
    # 0 picks the largest divisor <= 100; a prime above 100 degrades to 1.
    with pytest.warns(UserWarning, match="degraded to 1"):
        res = train(setup, params, ctx, lr=0.05, iters=101, batch_size=4, trainable=trainable,
                    loss_fn=_loss_on_vd())
    assert res.steps_done == 101


@pytest.mark.parametrize("field", ["checkpoint_every", "resume", "profile_dir"])
def test_unported_train_arguments_raise(field):
    setup, params, ctx, trainable = _quadratic_problem()
    value = {"checkpoint_every": 10, "resume": True, "profile_dir": "prof"}[field]
    with pytest.raises(NotImplementedError, match="not ported"):
        train(setup, params, ctx, lr=0.05, iters=10, batch_size=4, trainable=trainable,
              loss_fn=_loss_on_vd(), **{field: value})


def test_cadences_callback_keys_and_ring():
    setup, params, ctx, trainable = _quadratic_problem()
    infos = []
    res = train(setup, params, ctx, lr=0.05, iters=30, batch_size=4, trainable=trainable,
                loss_fn=_loss_on_vd(), log_every=3, callback_every=10, steps_per_call=15,
                callback=lambda i, info, z: infos.append((i, info, tuple(z.shape))),
                track_last_losses=8)
    assert len(res.losses) == 10                      # steps 0, 3, ..., 27
    assert [i for i, _, _ in infos] == [0, 10, 20]
    for i, info, z_shape in infos:
        assert set(info) == {"step", "loss", "grad_mean", "var_loss", "steps_per_sec", "eps",
                             "gamma", "eta"}
        assert info["step"] == i and z_shape == (4, 2)
        assert all(isinstance(v, (int, float)) for v in info.values())
    # The ring holds the last 8 per-iteration losses (steps 22..29), slot i % 8.
    full = train(setup, params, ctx, lr=0.05, iters=30, batch_size=4, trainable=trainable,
                 loss_fn=_loss_on_vd(), log_every=1)
    want = {i % 8: float(full.losses[i]) for i in range(22, 30)}
    for slot, value in want.items():
        assert float(res.last_losses[slot]) == pytest.approx(value, rel=1e-6)


def test_eager_training_lowers_the_vargrad_loss():
    """A few hundred eager VarGrad steps at a small size: the mean of the
    last 20 losses lies below the mean of the first 20."""
    target = load_target("many_gmm", device="cpu")
    setup = tb.CMCDSetup(mode="MCD_CAIS_var_sn", dim=2, nbridges=8, emb_dim=16,
                         grad_clipping=True)
    trainable = tb.default_trainable(setup.mode, train_eps=False, train_vi=False)
    params, ctx = tb.initialize(setup, target.log_prob, eps=0.65, init_sigma=15.0,
                                trainable=trainable, device="cpu")
    res = train(setup, params, ctx, lr=0.005, iters=300, batch_size=256, trainable=trainable,
                generator=torch.Generator().manual_seed(0), log_every=1)
    assert not res.diverged and len(res.losses) == 300
    assert float(res.losses[-20:].mean()) < float(res.losses[:20].mean())


def test_mfvi_pretrain_fits_the_variational_distribution():
    target = load_target("many_gmm", device="cpu")
    vd, elbo, res = mfvi_pretrain(2, target.log_prob, lr=0.05, iters=60, batch_size=64,
                                  generator=torch.Generator().manual_seed(0), init_sigma=15.0,
                                  device="cpu")
    assert set(vd) == {"mean", "logdiag"} and math.isfinite(elbo)
    assert res.last_losses.shape == (60,) and not torch.isnan(res.last_losses).any()
    assert elbo == pytest.approx(-float(res.last_losses.mean()), rel=1e-5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mfvi_pretrain(2, target.log_prob, iters=2)
