"""Experiment CLI (cmcd_tpu/main.py), evaluation only so far.

Same flag surface as the JAX CLI, parsed with argparse:
  python -m cmcd_tpu_torch.main --config.model many_gmm \\
      --config.boundmode MCD_CAIS_var_sn --config.nbridges 256 \\
      --config.emb_dim 130 --config.N 2000 --config.init_eps 0.65 \\
      --config.init_sigma 15 --config.grad_clipping True --config.iters 0 \\
      --noconfig.pretrain_mfvi

Phases: init, then the 30 x 500 evaluation, then ELBO and ln Z are printed.
On a CUDA device the evaluation always runs the fused rollout kernel, one
launch per seed group; a configuration the kernel does not cover, or
use_pallas_eval off, raises there instead of running eagerly. On the CPU
use_pallas_eval picks the kernel's plain twin or the eager integrator.
Training (iters > 0, MFVI pretraining) is not ported yet and raises, and so
does a non-default value of a field in NOT_PORTED.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from cmcd_tpu_torch import bounds
from cmcd_tpu_torch.config import Config, apply_lookup_tables, get_config
from cmcd_tpu_torch.distributions import diag_gaussian_init
from cmcd_tpu_torch.targets import load_target
from cmcd_tpu_torch.train import evaluate

# Fields the JAX CLI acts on even at iters 0 that the port does not
# implement yet: checkpoints, resume and the artifact dump, plots, the
# profiler, JSONL metrics. The remaining training fields (lr, N, mfvi_*,
# use_ema, use_pallas_train, bf16_fused_net, bf16_residuals, remat_steps,
# steps_per_call) act only once training runs, in both CLIs; the
# evaluation kernel computes in f32 in both.
NOT_PORTED = ("checkpoint_dir", "checkpoint_every", "resume", "plot_dir",
              "profile_dir", "log.every", "log.jsonl")


def _parse_bool(text: str) -> bool:
    low = text.strip().lower()
    if low in ("1", "true", "t", "yes"):
        return True
    if low in ("0", "false", "f", "no"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {text!r}")


def _parse_list(text: str) -> list:
    return [int(x) for x in text.strip("[]() ").replace(",", " ").split()]


def _add_fields(parser, obj, prefix: str):
    for field in dataclasses.fields(obj):
        value = getattr(obj, field.name)
        name = prefix + field.name
        if dataclasses.is_dataclass(value):
            _add_fields(parser, value, name + ".")
        elif isinstance(value, bool):
            parser.add_argument(f"--config.{name}", dest=name, nargs="?",
                                const=True, type=_parse_bool)
            parser.add_argument(f"--noconfig.{name}", dest=name,
                                action="store_false")
        elif isinstance(value, list):
            parser.add_argument(f"--config.{name}", dest=name, type=_parse_list)
        else:
            parser.add_argument(f"--config.{name}", dest=name, type=type(value))


def parse_flags(argv=None) -> Config:
    """`--config.X value`, `--config.X=value` and `--noconfig.X` onto the
    defaults of config.get_config()."""
    config = get_config()
    parser = argparse.ArgumentParser(
        prog="python -m cmcd_tpu_torch.main", argument_default=argparse.SUPPRESS
    )
    _add_fields(parser, config, "")
    for name, value in vars(parser.parse_args(argv)).items():
        *path, leaf = name.split(".")
        holder = config
        for part in path:
            holder = getattr(holder, part)
        setattr(holder, leaf, value)
    return config


def init_experiment(config: Config, device) -> tuple:
    """The mode init phase: (target, setup, params, ctx) on `device`."""
    target = load_target(config.model, config, device=device)
    setup = bounds.CMCDSetup(
        mode=config.boundmode,
        dim=target.dim,
        nbridges=config.nbridges,
        eps_schedule=config.eps_schedule,
        grad_clipping=config.grad_clipping,
        emb_dim=config.emb_dim,
        nlayers=config.nlayers,
        nn_arch=config.nn_arch,
    )
    trainable = bounds.default_trainable(
        setup.mode, config.train_eps, config.train_vi, config.train_betas
    )
    params, ctx = bounds.initialize(
        setup,
        target.log_prob,
        vdparams=diag_gaussian_init(target.dim, config.init_sigma, device=device),
        eps=config.init_eps,
        eta=config.init_eta,
        gamma=config.init_gamma,
        trainable=trainable,
        seed=config.seed,
        device=device,
    )
    return target, setup, params, ctx


def _field(config, name: str):
    for part in name.split("."):
        config = getattr(config, part)
    return config


def run_experiment(config: Config, device=None) -> dict:
    """Init, then evaluate; returns final ELBO / ln Z (+ stds), the
    negative-ELBO matrix and the samples."""
    for k, v in apply_lookup_tables(config).items():
        setattr(config, k, v)
    print(config)
    if config.iters > 0 or config.pretrain_mfvi:
        raise NotImplementedError("training: next PR, see ROADMAP")
    defaults = get_config()
    for name in NOT_PORTED:
        if _field(config, name) != _field(defaults, name):
            raise NotImplementedError(f"config.{name} is not ported yet; see ROADMAP")

    device = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))
    if device.type == "cuda" and not config.use_pallas_eval:
        raise NotImplementedError(
            "on a CUDA device the evaluation runs the fused kernel only; "
            "use_pallas_eval off is for CPU runs"
        )
    target, setup, params, ctx = init_experiment(config, device)
    generator = torch.Generator(device=device).manual_seed(config.seed)

    eval_elbo_fn = None
    if config.use_pallas_eval:
        from cmcd_tpu_torch.ops import compute_elbos_fused, supports_fused

        if not supports_fused(setup, target):
            if device.type == "cuda":
                raise NotImplementedError(
                    f"no fused CUDA kernel for mode {setup.mode} on {target.name} "
                    f"(nn {setup.nn_arch}, emb_dim {setup.emb_dim}); see ROADMAP queue B"
                )
        else:
            eval_elbo_fn = lambda p, n, g: compute_elbos_fused(p, n, setup, target, generator=g)
            print(f"Using the fused evaluation path on {device.type}.")

    out = evaluate(
        params,
        ctx,
        setup,
        generator=generator,
        n_samples=config.n_samples,
        n_input_dist_seeds=config.n_input_dist_seeds,
        elbo_fn=eval_elbo_fn,
    )
    print("Got ELBO %.4f." % out["final_elbo"])
    print("Got ln Z %.4f." % out["final_ln_Z"])
    return out


def main(argv=None):
    run_experiment(parse_flags(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
