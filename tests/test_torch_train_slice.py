"""The port's training slice end to end against the JAX package, on the
CPU: five optimizer steps of `train` in both packages from the same
parameters under the same draws, and the CLI's training phases
(run_experiment with iters > 0, the JSONL log, EMA, MFVI pretraining)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmcd_tpu import bounds as jb
from cmcd_tpu.distributions import diag_gaussian_log_prob as j_log_prob
from cmcd_tpu.integrators import overdamped as jod
from cmcd_tpu.schedules import betas_from_grid as j_betas_from_grid
from cmcd_tpu.train import trainer as jtrainer
from cmcd_tpu_torch import bounds as tb
from cmcd_tpu_torch.main import parse_args, parse_flags, run_experiment
from cmcd_tpu_torch.ops.fused_train import var_bound_fused
from cmcd_tpu_torch.train import train
from cmcd_tpu_torch.utils.convert import params_to_numpy
from test_torch_vargrad import make_case

torch.set_num_threads(1)

STEPS = 5


def _draws(case):
    rng = np.random.default_rng(11)
    n, k = case["n"], case["k"]
    return [(rng.standard_normal((n, 2)).astype(np.float32),
             rng.standard_normal((k, n, 2)).astype(np.float32)) for _ in range(STEPS)]


def _jax_five_steps(case, draws):
    """The JAX trainer with a loss_fn that takes its draws from `draws`: the
    step index rides in the key (train splits it once per step)."""
    setup, ctx = case["jsetup"], case["jctx"]
    base_all = jnp.asarray(np.stack([d[0] for d in draws]))
    noise_all = jnp.asarray(np.stack([d[1] for d in draws]))
    key = jax.random.PRNGKey(0)
    step_keys = []
    for _ in range(STEPS):
        key, step_key = jax.random.split(key)
        step_keys.append(step_key)
    step_keys = jnp.stack(step_keys)

    def loss_fn(full, step_key, n, ctx, setup):
        t = jnp.argmax(jnp.all(step_keys == step_key, axis=-1))
        p = jb.merged_params(full)
        z = p["vd"]["mean"] + jnp.exp(p["vd"]["logdiag"]) * base_all[t]
        w = -j_log_prob(p["vd"], z)
        betas = j_betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])
        z, wd, _ = jod.evolve_overdamped(step_key, z, betas, p, ctx, jod.CAIS_VAR,
                                         noise=noise_all[t])
        neg = -(w + wd + ctx.target_log_prob(z))
        return jnp.clip(jnp.var(neg, ddof=0), -1e7, 1e7), (neg, z)

    return jtrainer.train(
        setup, case["jparams"], ctx, lr=0.005, iters=STEPS, batch_size=case["n"],
        key=jax.random.PRNGKey(0), trainable=jb.default_trainable(setup.mode),
        loss_fn=loss_fn, log_every=1, steps_per_call=1)


@pytest.mark.parametrize("path", ["eager", "fused"])
def test_five_training_steps_match_the_jax_trainer(path):
    case = make_case()
    draws = _draws(case)
    want = _jax_five_steps(case, draws)
    step = {"i": 0}

    def loss_fn(params, n, ctx, setup, generator=None):
        base, noise = draws[step["i"]]
        step["i"] += 1
        kw = dict(base_normals=torch.from_numpy(base), noise=torch.from_numpy(noise))
        if path == "fused":
            return var_bound_fused(params, n, ctx, setup, case["target"], **kw)
        return tb.var_bound(params, n, ctx, setup, **kw)

    got = train(case["setup"], case["params"], case["ctx"], lr=0.005, iters=STEPS,
                batch_size=case["n"], trainable=tb.default_trainable(case["setup"].mode),
                loss_fn=loss_fn, log_every=1)
    assert got.steps_done == STEPS and not got.diverged and not bool(want.diverged)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses), rtol=1e-4)
    got_tree = params_to_numpy(got.params["train"])
    want_tree = jax.device_get(want.params["train"])
    got_l, treedef = jax.tree_util.tree_flatten(got_tree)
    want_l, want_def = jax.tree_util.tree_flatten(want_tree)
    assert treedef == want_def
    moved = 0.0
    start = jax.tree_util.tree_leaves(jax.device_get(case["jparams"]["train"]))
    for g, w, s in zip(got_l, want_l, start):
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w) + 1e-7
        moved += float(np.linalg.norm(np.asarray(w) - np.asarray(s)))
    assert moved > 0.1  # five Adam steps did move the parameters


TINY = ("--config.model many_gmm --config.boundmode MCD_CAIS_var_sn --config.nbridges 4 "
        "--config.emb_dim 8 --config.N 32 --config.n_samples 32 "
        "--config.n_input_dist_seeds 2 --config.init_eps 0.65 --config.init_sigma 15 "
        "--config.grad_clipping True --config.lr 0.005 --config.iters 20 "
        "--noconfig.pretrain_mfvi").split()


@pytest.mark.parametrize("fused", [True, False])
def test_run_experiment_trains_and_logs_on_cpu(tmp_path, capsys, fused):
    log = os.path.join(tmp_path, "metrics.jsonl")
    flags = TINY + ["--config.log.jsonl", log, "--config.use_ema"]
    if not fused:
        flags += ["--noconfig.use_pallas_train"]
    config, device = parse_args(flags + ["--device", "cpu"])
    assert device == "cpu"
    out = run_experiment(config, device=device)
    printed = capsys.readouterr().out
    assert ("Using the fused training path on cpu" in printed) == fused
    assert ("bf16_fused_net is ignored" in printed) == fused
    result = out["train"]
    assert result.steps_done == 20 and not result.diverged
    assert len(result.losses) == 20 and torch.isfinite(result.losses).all()
    assert out["neg_elbos"].shape == (2, 32) and out["samples"].shape == (64, 2)
    for key in ("final_elbo", "final_ln_Z", "final_elbo_ema", "final_ln_Z_ema"):
        assert np.isfinite(out[key]), key
    with open(log) as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if "loss" in r]
    assert [r["step"] for r in steps] == list(range(20))  # callback_every = max(20 // 100, 1)
    for r in steps:
        assert {"step", "loss", "grad_mean", "var_loss", "eps", "gamma",
                "chain_steps_per_sec", "wall_time"} <= set(r)
    assert "final_ln_Z" in records[-1]


KL_TINY = ("--config.model many_gmm --config.boundmode MCD_CAIS_sn --config.nbridges 4 "
           "--config.emb_dim 8 --config.N 64 --config.n_samples 32 "
           "--config.n_input_dist_seeds 2 --config.init_eps 0.1 --config.init_sigma 15 "
           "--config.grad_clipping True --config.lr 0.01 --config.iters 60 "
           "--config.log.every 1 --noconfig.pretrain_mfvi").split()


@pytest.mark.parametrize("fused", [True, False])
def test_run_experiment_kl_training_lowers_the_loss_on_cpu(capsys, fused):
    """MCD_CAIS_sn through the CLI's phases on the CPU: the fused KL loss
    (plain versions of the rollout and the reverse sweep) or the eager one,
    whose autograd gradient is the full backprop through time."""
    flags = KL_TINY + ["--config.remat_steps", "--config.bf16_residuals"]
    if not fused:
        flags += ["--noconfig.use_pallas_train"]
    out = run_experiment(parse_flags(flags), device="cpu")
    printed = capsys.readouterr().out
    assert ("kl_bound_fused, KL reverse sweep" in printed) == fused
    for field in ("remat_steps", "bf16_residuals", "bf16_fused_net"):
        assert (f"{field} is ignored" in printed) == fused
    result = out["train"]
    assert result.steps_done == 60 and not result.diverged
    losses = result.losses.double()
    assert len(losses) == 60 and torch.isfinite(losses).all()
    assert float(losses[-15:].mean()) < float(losses[:15].mean())
    assert np.isfinite(out["final_ln_Z"]) and np.isfinite(out["final_elbo"])


def test_run_experiment_names_the_vargrad_backward_it_takes(capsys, monkeypatch):
    from cmcd_tpu_torch.ops import fused_train

    run_experiment(parse_flags(TINY + ["--config.iters", "2"]), device="cpu")
    assert "var_bound_fused, VarGrad replay backward" in capsys.readouterr().out
    monkeypatch.setattr(fused_train, "_REPLAY_BYTES_BUDGET", 64)
    out = run_experiment(parse_flags(TINY + ["--config.iters", "2"]), device="cpu")
    assert "var_bound_fused, VarGrad reroll backward" in capsys.readouterr().out
    assert out["train"].steps_done == 2 and not out["train"].diverged


@pytest.mark.parametrize("mode,path", [("MCD_CAIS_sn", "kl_bound_fused, KL reverse sweep"),
                                       ("MCD_CAIS_var_sn", "VarGrad replay backward")])
def test_recipe_trace_reports_checkpoints_and_a_gradient_check_on_cpu(capsys, mode, path):
    """tools/recipe_trace: an evaluation line per checkpoint, and at the
    gradient check the step through the wrappers and through plain=True
    (both the plain versions on the CPU) within rounding of the float64 step."""
    from cmcd_tpu_torch.tools import recipe_trace

    flags = [f.replace("MCD_CAIS_sn", mode) for f in KL_TINY]
    flags = flags[:flags.index("--config.iters")] + flags[flags.index("--config.iters") + 2:]
    recipe_trace.main(["--device", "cpu", "--seeds", "3", "--checkpoints", "0,5,10",
                       "--grad-checks", "10", *flags, "--config.iters", "10",
                       "--config.n_samples", "50", "--config.n_input_dist_seeds", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert any(path in ln for ln in lines)
    traces = [json.loads(ln[len("[trace] "):]) for ln in lines if ln.startswith("[trace] ")]
    assert [t["step"] for t in traces] == [0, 5, 10] and all(t["seed"] == 3 for t in traces)
    assert all(np.isfinite(t["final_elbo"]) and len(t["ln_Z_by_group"]) == 3 for t in traces)
    assert traces[0]["modes"]["n"] == 40 and "train_loss_last_100" in traces[-1]
    (check,) = [json.loads(ln[len("[gradient] "):]) for ln in lines if ln.startswith("[gradient] ")]
    assert check["step"] == 10 and check["loss"]["kernel"] == check["loss"]["plain"]
    assert all(row["kernel_vs_plain"] == 0.0 for row in check["leaves"])
    assert check["worst_plain_vs_f64"] < 1e-3 and check["cosine_kernel_f64"] > 0.999999


def test_run_experiment_pretrains_mfvi_on_cpu(capsys):
    flags = [f for f in TINY if f != "--noconfig.pretrain_mfvi"]
    flags += ["--config.pretrain_mfvi", "--config.mfvi_iters", "50", "--config.iters", "4"]
    out = run_experiment(parse_flags(flags), device="cpu")
    printed = capsys.readouterr().out
    assert "Done training initial parameters, got ELBO" in printed
    assert np.isfinite(out["final_ln_Z"]) and out["train"].steps_done == 4


def test_run_experiment_needs_a_card_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_experiment(parse_flags(TINY))
    # On the card training never goes eager: refused before anything runs.
    with pytest.raises(NotImplementedError, match="fused kernel only"):
        run_experiment(parse_flags(TINY + ["--noconfig.use_pallas_train"]), device="cuda")
