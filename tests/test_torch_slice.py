"""The port's evaluation slice end to end against the JAX package, on the
CPU: compute_elbos_fused (plain twin on a CPU tensor) and the eager
compute_elbos against JAX's compute_elbos_fused(interpret=True) under the
same draws, the loss values, evaluate's ln Z aggregation, the CLI with its
device default (the card unless the caller asks for the CPU), and the rule
that the port never imports JAX. The training slice has its own file,
tests/test_torch_train_slice.py."""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cmcd_tpu
from cmcd_tpu.ops.fused import compute_elbos_fused as j_compute_elbos_fused
from cmcd_tpu.train.evaluate import evaluate as j_evaluate
from cmcd_tpu_torch import bounds as tb
from cmcd_tpu_torch.main import main, parse_flags, run_experiment
from cmcd_tpu_torch.ops.fused import compute_elbos_fused, supports_fused
from cmcd_tpu_torch.targets import load_target
from cmcd_tpu_torch.train import evaluate
from cmcd_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

K, N, EMB = 6, 128, 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def problem():
    """Flagship-shaped (MCD_CAIS_var_sn, grad clipping, eps 0.65, sigma 15)
    at K=6, emb 16; factor_sn 0.3 and non-uniform beta knots so the net
    and the grid matter. JAX's result is computed once."""
    jt = cmcd_tpu.load_target("many_gmm")
    jsetup = cmcd_tpu.CMCDSetup(mode="MCD_CAIS_var_sn", dim=2, nbridges=K, emb_dim=EMB,
                                grad_clipping=True)
    trainable = cmcd_tpu.default_trainable(jsetup.mode, train_eps=False, train_vi=False)
    params, _ = cmcd_tpu.initialize(jsetup, jt.log_prob, eps=0.65, init_sigma=15.0,
                                    trainable=trainable)
    params["train"]["sn"]["factor_sn"] = jnp.asarray(0.3)
    params["train"]["mgridref_y"] = jax.random.uniform(
        jax.random.PRNGKey(9), (K + 1,), minval=0.5, maxval=1.5)
    key = jax.random.PRNGKey(7)
    z_key, _ = jax.random.split(key)
    base = np.array(jax.random.normal(z_key, (N, 2)))
    noise = np.random.default_rng(0).standard_normal((K, N, 2)).astype(np.float32)
    neg, z = j_compute_elbos_fused(params, key, N, jsetup, jt, noise=jnp.asarray(noise),
                                   interpret=True)
    tsetup = tb.CMCDSetup(mode="MCD_CAIS_var_sn", dim=2, nbridges=K, emb_dim=EMB,
                          grad_clipping=True)
    target = load_target("many_gmm", device="cpu")
    _, ctx = tb.initialize(tsetup, target.log_prob, device="cpu")
    return {
        "params": params_from_jax(jax.device_get(params), device="cpu"),
        "setup": tsetup, "target": target, "ctx": ctx,
        "draws": {"base_normals": torch.from_numpy(base), "noise": torch.from_numpy(noise)},
        "neg": np.asarray(neg), "z": np.asarray(z),
    }


@pytest.mark.parametrize("path", ["fused", "eager"])
def test_neg_elbos_match_jax_fused_kernel(problem, path):
    p = problem
    if path == "fused":
        neg, z = compute_elbos_fused(p["params"], N, p["setup"], p["target"], **p["draws"])
    else:
        with torch.no_grad():
            neg, z = tb.compute_elbos(p["params"], N, p["ctx"], p["setup"], **p["draws"])
    np.testing.assert_allclose(z.numpy(), p["z"], atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(neg.numpy(), p["neg"], atol=1e-3, rtol=1e-4)


def test_loss_values_use_population_variance(problem):
    p = problem
    with torch.no_grad():
        var, (neg, _) = tb.var_bound(p["params"], N, p["ctx"], p["setup"], **p["draws"])
        kl, _ = tb.kl_bound(p["params"], N, p["ctx"], p["setup"], **p["draws"])
    want_var = float(jnp.clip(jnp.var(jnp.asarray(p["neg"]), ddof=0), -1e7, 1e7))
    assert float(var) == pytest.approx(want_var, rel=1e-3)
    assert float(var) == pytest.approx(float(torch.var(neg, correction=0)), rel=1e-6)
    assert float(kl) == pytest.approx(float(np.mean(p["neg"])), rel=1e-4, abs=1e-3)


def test_evaluate_aggregation_matches_jax():
    s, n = 5, 16
    rng = np.random.default_rng(1)
    mat = (rng.standard_normal((s, n)) * 3.0 + 5.0).astype(np.float32)
    mat[2, 3] = 40.0  # a heavy chain: logsumexp must not be a mean
    key = jax.random.PRNGKey(2)
    keys = jax.random.split(key, s)

    def j_elbo_fn(p, k, n_):
        row = jnp.argmax(jnp.all(keys == k, axis=-1))
        return jnp.asarray(mat)[row], jnp.zeros((n_, 2))

    want = j_evaluate({}, None, None, key=key, n_samples=n, n_input_dist_seeds=s,
                      elbo_fn=j_elbo_fn)
    rows = iter(torch.from_numpy(mat))
    got = evaluate({}, None, None, n_samples=n, n_input_dist_seeds=s,
                   elbo_fn=lambda p, n_, g: (next(rows), torch.zeros(n_, 2)))
    np.testing.assert_array_equal(got["neg_elbos"], np.asarray(want["neg_elbos"]))
    for k in ("final_elbo", "final_elbo_std", "final_ln_Z", "final_ln_Z_std"):
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), k
    assert got["samples"].shape == (s * n, 2)


TINY = ("--config.model many_gmm --config.boundmode MCD_CAIS_var_sn --config.nbridges 4 "
        "--config.emb_dim 8 --config.N 32 --config.n_samples 32 "
        "--config.n_input_dist_seeds 2 --config.init_eps 0.65 --config.init_sigma 15 "
        "--config.grad_clipping True --config.iters 0 --noconfig.pretrain_mfvi").split()


def test_cli_evaluates_with_iters_zero_on_cpu(capsys):
    main(TINY + ["--device", "cpu"])
    out = capsys.readouterr().out
    lnz = re.search(r"Got ln Z (\S+)\.", out)
    assert lnz and np.isfinite(float(lnz.group(1)))
    assert "Got ELBO" in out
    assert "Using the fused evaluation path on cpu." in out


@pytest.mark.parametrize("extra", [["--config.iters", "5"], ["--config.pretrain_mfvi"]])
def test_training_is_refused(extra):
    """Without a card nothing runs unless the caller asks for the CPU:
    no silent CPU run. With device="cpu" the same flags train."""
    flags = TINY + extra + ["--config.mfvi_iters", "20"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_experiment(parse_flags(flags))
    out = run_experiment(parse_flags(flags), device="cpu")
    assert np.isfinite(out["final_ln_Z"]) and not out["train"].diverged


def test_cli_evaluates_eagerly_without_the_fused_path_on_cpu(capsys):
    main(TINY + ["--noconfig.use_pallas_eval", "--device", "cpu"])
    out = capsys.readouterr().out
    lnz = re.search(r"Got ln Z (\S+)\.", out)
    assert lnz and np.isfinite(float(lnz.group(1)))
    assert "Using the fused" not in out


def test_cuda_evaluation_never_goes_eager():
    """use_pallas_eval off on a CUDA device raises before anything touches
    the card (no card needed)."""
    with pytest.raises(NotImplementedError, match="fused kernel only"):
        run_experiment(parse_flags(TINY + ["--noconfig.use_pallas_eval"]), device="cuda")


@pytest.mark.parametrize("extra", [["--config.plot_dir", "plots"],
                                   ["--config.checkpoint_dir", "ckpt"],
                                   ["--config.resume"],
                                   ["--config.profile_dir", "prof"]])
def test_unported_fields_are_refused(extra):
    with pytest.raises(NotImplementedError, match="not ported"):
        run_experiment(parse_flags(TINY + extra), device="cpu")


def test_flag_forms():
    cfg = parse_flags(["--config.N=7", "--config.grad_clipping", "--noconfig.train_vi",
                       "--config.fully_connected_units", "[32, 16]",
                       "--config.log.jsonl", "m.jsonl", "--config.init_sigma", "15"])
    assert (cfg.N, cfg.grad_clipping, cfg.train_vi) == (7, True, False)
    assert cfg.fully_connected_units == [32, 16] and cfg.log.jsonl == "m.jsonl"
    assert cfg.init_sigma == 15.0 and cfg.boundmode == "UHA"  # defaults kept


def test_supports_fused_gate():
    target = load_target("many_gmm", device="cpu")
    ok = tb.CMCDSetup(mode="MCD_CAIS_var_sn", dim=2, nbridges=256, emb_dim=130)
    assert supports_fused(ok, target)
    assert supports_fused(tb.CMCDSetup(mode="MCD_CAIS_sn", dim=2, nbridges=8), target)
    # ULA_sn, plain ULA and DNF run through the rollout kernel's other forms;
    # DNF with a PIS net is refused, as the JAX package fuses none.
    assert supports_fused(tb.CMCDSetup(mode="MCD_ULA_sn", dim=2, nbridges=8), target)
    assert supports_fused(tb.CMCDSetup(mode="MCD_DNF", dim=2, nbridges=8), target)
    assert not supports_fused(tb.CMCDSetup(mode="MCD_DNF", dim=2, nbridges=8, nn_arch="dds",
                                           fully_connected_units=(16, 16)), target)
    # in_dim 302 needs more threads and shared memory than one block has.
    assert not supports_fused(
        tb.CMCDSetup(mode="MCD_CAIS_var_sn", dim=2, nbridges=8, emb_dim=300), target)


_BANNED = ("jax", "jaxlib", "cmcd_tpu", "absl", "ml_collections", "optax", "orbax")


def test_port_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(%s)\b(?!_torch)" % "|".join(_BANNED))
    offenders = []
    for root, _, files in os.walk(os.path.join(REPO, "cmcd_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as f:
                    offenders += [f"{path}:{i}" for i, line in enumerate(f, 1)
                                  if pattern.match(line)]
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        offenders += [f"chip_smoke.py:{i}" for i, line in enumerate(f, 1) if pattern.match(line)]
    assert offenders == []


def test_importing_the_port_leaves_jax_out():
    """A fresh interpreter that refuses JAX and the JAX package can import
    every module of the port (walked, not listed) and the top level of
    chip_smoke.py, and jax is not in sys.modules afterwards."""
    code = f"""
import importlib, pkgutil, sys
BANNED = {_BANNED!r}
for m in list(sys.modules):
    if m.split(".")[0] in BANNED:
        del sys.modules[m]
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("the port imported " + name)
sys.meta_path.insert(0, Refuse())
import cmcd_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cmcd_tpu_torch.__path__, "cmcd_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert callable(chip_smoke.main)
assert "jax" not in sys.modules
for name in ("ops.kl", "ops.underdamped", "ops.kl_underdamped", "ops.uha", "ops.kl_uha",
             "ops.overdamped_wide", "ops.kl_split", "targets.lgcp",
             "tools.recipe_trace", "integrators.uha", "main"):
    assert "cmcd_tpu_torch." + name in names, name
print("clean", len(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().startswith("clean")
