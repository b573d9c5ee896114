"""Experiment CLI (cmcd_tpu/main.py).

Same flag surface as the JAX CLI, parsed with argparse:
  python -m cmcd_tpu_torch.main --config.model many_gmm \\
      --config.boundmode MCD_CAIS_var_sn --config.nbridges 256 \\
      --config.emb_dim 130 --config.N 2000 --config.init_eps 0.65 \\
      --config.init_sigma 15 --config.grad_clipping True --config.lr 0.005 \\
      --config.train_eps False --config.train_vi False --config.iters 40000 \\
      --noconfig.pretrain_mfvi
plus `--device cpu` (outside the --config.* namespace, which mirrors the JAX
config field for field): the CLI and run_experiment run on the card and
raise when there is none, unless the caller asks for the CPU.

Phases: optional MFVI pretraining, mode init, training, the 30 x 500
evaluation (and the EMA parameters' when use_ema), JSONL metrics
(log.jsonl). On a CUDA device training runs through a fused loss
(ops/fused_train: var_bound_fused for MCD_CAIS_var_sn, the rollout kernel
with its trajectory and the replay or re-rolling backward kernel;
kl_bound_fused for MCD_CAIS_sn, MCD_ULA_sn, plain MCD_ULA and MCD_DNF, the
rollout kernel with trajectory and noise and the reverse-sweep kernel of the
mode's form (the net in both kernels, in the backward kernel only, none, or
DNF's two geffner nets with zero drift); for
the seven underdamped modes (MCD_U_a-lp, -sna, -sn (LDVI), the exact
refresh's MCD_U_e-lp and -sna, MCD_U_ea-lp-sn and MCD_CAIS_UHA_sn), the
underdamped rollout kernel with its stores and the underdamped sweep; for
UHA, the default boundmode, the UHA rollout kernel with its stores and the
UHA sweep) and evaluation through the fused rollout of the mode's family,
one launch per seed group. Every family runs on many_gmm, the 3-mode gmm
(the gmm recipes of experiments/recipes.py: gmm_cais, gmm_cais_tuned,
gmm_ula) and Neal's funnel at funnel_d 10 (funnel_k8: MCD_CAIS_sn,
n_samples 2000, so a 30 x 2000 evaluation; with nbridges 32 and
MCD_CAIS_UHA_sn the underdamped CAIS record); the 1600-D LGCP
(`--config.model lgcp`, `--config.use_whitened`, `--config.file_path`;
lgcp_k8: MFVI pretraining, then MCD_CAIS_sn through the wide rollout and
the split KL sweep, kl_bound_fused's "wide rollout and split KL reverse
sweep (B12)") takes MCD_CAIS_sn with the geffner net only, and so do the
Bayesian logistic regressions (`--config.model log_australian`,
`log_ionosphere`, `log_sonar`: MFVI pretraining, then the overdamped rollout's
and the KL sweep's logreg instances); a configuration the kernels
do not cover, or use_pallas_train / use_pallas_eval off, raises there
instead of running eagerly. On the CPU the two switches pick the kernels'
plain versions or the eager integrator. The fields in IGNORED are accepted and ignored with
one printed line each. A non-default value of a field in NOT_PORTED raises.
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
from cmcd_tpu_torch.train import evaluate, mfvi_pretrain, train
from cmcd_tpu_torch.utils import MetricLogger, ThroughputMeter, resolve_device

# Fields of the JAX CLI that the port does not implement yet: checkpoints,
# resume and the artifact dump, plots, the profiler.
NOT_PORTED = ("checkpoint_dir", "checkpoint_every", "resume", "plot_dir",
              "profile_dir")

# Switches that the fused training path accepts and ignores when on, each with why.
# bf16_fused_net, bf16_residuals and remat_steps size the JAX package's KL
# sweep and its residuals to a TPU's on-chip memory (its bf16 split sweep
# fits the LGCP's net there); here the weights and the trajectory and noise
# stay f32 in device memory, the split sweep (B12) included. bf16 compute
# is queued (ROADMAP B13).
IGNORED = {
    "bf16_fused_net": "the backward kernels compute in f32, the split sweep (B12) included",
    "bf16_residuals": "the KL residuals (trajectory, noise) are stored in f32",
    "remat_steps": "the fused KL backward keeps no per-step residuals to rematerialise",
}


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


def parse_args(argv=None) -> tuple:
    """`--config.X value`, `--config.X=value` and `--noconfig.X` onto the
    defaults of config.get_config(), and `--device`: (config, device or None)."""
    config = get_config()
    parser = argparse.ArgumentParser(
        prog="python -m cmcd_tpu_torch.main", argument_default=argparse.SUPPRESS
    )
    parser.add_argument("--device", dest="--device",
                        help="where to run: default the card; cpu runs on the CPU")
    _add_fields(parser, config, "")
    args = vars(parser.parse_args(argv))
    device = args.pop("--device", None)
    for name, value in args.items():
        *path, leaf = name.split(".")
        holder = config
        for part in path:
            holder = getattr(holder, part)
        setattr(holder, leaf, value)
    return config, device


def parse_flags(argv=None) -> Config:
    """The config part of parse_args."""
    return parse_args(argv)[0]


def init_experiment(config: Config, device, target=None, vdparams=None) -> tuple:
    """The mode init phase: (target, setup, params, ctx) on `device`;
    target: already loaded, if so; vdparams: the pretrained variational
    distribution, if any."""
    target = target or load_target(config.model, config, device=device)
    setup = bounds.CMCDSetup(
        mode=config.boundmode,
        dim=target.dim,
        nbridges=config.nbridges,
        eps_schedule=config.eps_schedule,
        grad_clipping=config.grad_clipping,
        emb_dim=config.emb_dim,
        nlayers=config.nlayers,
        nn_arch=config.nn_arch,
        fully_connected_units=tuple(config.fully_connected_units),
        lfsteps=config.lfsteps,
    )
    trainable = bounds.default_trainable(
        setup.mode, config.train_eps, config.train_vi, config.train_betas
    )
    params, ctx = bounds.initialize(
        setup,
        target.log_prob,
        vdparams=vdparams if vdparams is not None
        else diag_gaussian_init(target.dim, config.init_sigma, device=device),
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


def _use_fused(what, switch, supported, device, setup, target) -> bool:
    """Whether `what` runs fused. On the CPU the switch and the kernels'
    coverage decide; on the card an uncovered configuration raises (the
    switch itself was checked before anything touched the card)."""
    if device.type == "cuda" and not supported:
        raise NotImplementedError(
            f"no fused CUDA kernel for {what} of mode {setup.mode} on {target.name} "
            f"(nn {setup.nn_arch}, emb_dim {setup.emb_dim}); see ROADMAP queue B"
        )
    return switch and supported


def run_experiment(config: Config, device=None) -> dict:
    """[MFVI pretrain] -> init -> train -> evaluate; returns final ELBO /
    ln Z (+ stds, + EMA), the negative-ELBO matrix, the samples and the
    TrainResult. device=None is the card (utils/device.resolve_device)."""
    for k, v in apply_lookup_tables(config).items():
        setattr(config, k, v)
    print(config)
    defaults = get_config()
    for name in NOT_PORTED:
        if _field(config, name) != _field(defaults, name):
            raise NotImplementedError(f"config.{name} is not ported yet; see ROADMAP")
    device = resolve_device(device)
    if device.type == "cuda":
        for switch, what in ((config.use_pallas_eval, "the evaluation"),
                             (config.use_pallas_train or config.iters <= 0, "training")):
            if not switch:
                raise NotImplementedError(
                    f"on a CUDA device {what} runs the fused kernel only; "
                    "use_pallas_eval / use_pallas_train off are for CPU runs"
                )
    logger = MetricLogger(config.log.jsonl)
    try:
        return _run_phases(config, device, logger)
    finally:
        logger.close()


def _run_phases(config: Config, device, logger: MetricLogger) -> dict:
    from cmcd_tpu_torch.ops import (
        compute_elbos_fused,
        fused_training_path,
        supports_fused,
        supports_fused_train,
    )

    generator = torch.Generator(device=device).manual_seed(config.seed)
    eval_generator = torch.Generator(device=device).manual_seed(config.seed + 1)

    target = load_target(config.model, config, device=device)
    vdparams = None
    if config.pretrain_mfvi:
        vdparams, elbo_init, _ = mfvi_pretrain(
            target.dim, target.log_prob, lr=config.mfvi_lr, iters=config.mfvi_iters,
            batch_size=config.N, generator=generator, init_sigma=config.init_sigma,
            device=device,
        )
        print("Done training initial parameters, got ELBO %.2f." % elbo_init)
        logger.log({"elbo_init": elbo_init})

    target, setup, params, ctx = init_experiment(config, device, target, vdparams)
    trainable = bounds.default_trainable(
        setup.mode, config.train_eps, config.train_vi, config.train_betas
    )

    eval_elbo_fn = None
    if _use_fused("the evaluation", config.use_pallas_eval,
                  supports_fused(setup, target), device, setup, target):
        eval_elbo_fn = lambda p, n, g: compute_elbos_fused(p, n, setup, target, generator=g)
        print(f"Using the fused evaluation path on {device.type}.")

    train_loss_fn = None
    if config.iters > 0 and _use_fused(
            "training", config.use_pallas_train, supports_fused_train(setup, target),
            device, setup, target):
        fused_loss, path = fused_training_path(setup, config.N)
        train_loss_fn = lambda p, n, c, s, generator: fused_loss(
            p, n, c, s, target, generator=generator)
        print(f"Using the fused training path on {device.type} "
              f"(forward + backward kernels: {path}).")
        for name, why in IGNORED.items():
            if getattr(config, name):
                print(f"{name} is ignored: {why}.")

    meter = ThroughputMeter(config.N, config.nbridges)

    def callback(step, info, z):
        info["chain_steps_per_sec"] = meter.chain_rate(info["steps_per_sec"])
        logger.log(info, step=step)

    result = train(
        setup, params, ctx, lr=config.lr, iters=config.iters, batch_size=config.N,
        generator=generator, trainable=trainable, loss_fn=train_loss_fn,
        use_ema=config.use_ema, callback=callback, log_every=config.log.every or None,
        steps_per_call=config.steps_per_call,
    )
    if result.diverged:
        print("Diverged at step %d; evaluating last finite params." % result.steps_done)
    params = result.params

    def run_eval(p):
        return evaluate(p, ctx, setup, generator=eval_generator, n_samples=config.n_samples,
                        n_input_dist_seeds=config.n_input_dist_seeds, elbo_fn=eval_elbo_fn)

    out = run_eval(params)
    print("Got ELBO %.4f." % out["final_elbo"])
    print("Got ln Z %.4f." % out["final_ln_Z"])
    logger.log({k: v for k, v in out.items() if isinstance(v, float)})
    out["train"] = result

    if config.use_ema and result.ema_params is not None:
        out_ema = run_eval(result.ema_params)
        print("With EMA, got ELBO %.4f." % out_ema["final_elbo"])
        print("With EMA, got ln Z %.4f." % out_ema["final_ln_Z"])
        out["final_elbo_ema"] = out_ema["final_elbo"]
        out["final_ln_Z_ema"] = out_ema["final_ln_Z"]

    return out


def main(argv=None):
    config, device = parse_args(argv)
    run_experiment(config, device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
