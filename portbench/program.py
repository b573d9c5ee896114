"""The system under test, cmcd_tpu_torch, driven the way its CLI drives it
(cmcd_tpu_torch/main.py::_run_phases): the target and the parameters from
init_experiment, training through train() with the fused loss of
ops.fused_training_path, evaluation through train.evaluate with
ops.compute_elbos_fused. The only departure: every parameter is overwritten
with the benchmark's own draw from the seed (harness.make_weights), so that
the reference starts from the same numbers without reading the program's.

This is the one module of the benchmark that imports the program.
"""

from __future__ import annotations

import torch

# The program's parameter leaves (trainer.tree_leaf_names) by the
# reference's names.
LEAVES = {
    "sn.layers.0.weight": "W1", "sn.layers.0.bias": "b1",
    "sn.layers.1.weight": "W2", "sn.layers.1.bias": "b2",
    "sn.head.weight": "Wh", "sn.head.bias": "bh", "sn.emb": "emb", "sn.factor_sn": "factor",
    "mgridref_y": "knots", "eps": "eps", "vd.mean": "vd_mean", "vd.logdiag": "vd_logdiag",
}


class Program:
    """One configuration of the program on `device`, with its parameters
    set to `weights` (the reference's names)."""

    def __init__(self, config: dict, weights: dict, device):
        from cmcd_tpu_torch import bounds
        from cmcd_tpu_torch.config import apply_lookup_tables, get_config
        from cmcd_tpu_torch.main import init_experiment
        from cmcd_tpu_torch.ops import compute_elbos_fused, fused_training_path
        from cmcd_tpu_torch.targets import load_target
        from cmcd_tpu_torch.train.trainer import tree_leaf_names, tree_leaves

        cfg = get_config()
        for key, value in config["flags"].items():
            setattr(cfg, key, value)
        for key, value in apply_lookup_tables(cfg).items():
            setattr(cfg, key, value)
        self.cfg = cfg
        target = load_target(cfg.model, cfg, device=device)
        vd = {"mean": weights["vd_mean"].clone(), "logdiag": weights["vd_logdiag"].clone()}
        target, setup, params, ctx = init_experiment(cfg, device, target, vd)
        with torch.no_grad():
            for tree in (params["train"], params["notrain"]):
                for name, leaf in zip(tree_leaf_names(tree), tree_leaves(tree)):
                    if name in LEAVES:
                        leaf.copy_(weights[LEAVES[name]])
        self.target, self.setup, self.params, self.ctx = target, setup, params, ctx
        self.trainable = bounds.default_trainable(setup.mode, cfg.train_eps, cfg.train_vi,
                                                  cfg.train_betas)
        fused_loss, self.path = fused_training_path(setup, cfg.N)
        self.loss_fn = lambda p, n, c, s, generator: fused_loss(p, n, c, s, target,
                                                                generator=generator)
        self.elbo_fn = lambda p, n, g: compute_elbos_fused(p, n, setup, target, generator=g)

    def leaf_names(self) -> list:
        """The reference's name of each trainable leaf, in the order of the
        trainer's leaves (trainer.tree_leaves of params["train"])."""
        from cmcd_tpu_torch.train.trainer import tree_leaf_names

        return [LEAVES.get(n) for n in tree_leaf_names(self.params["train"])]

    def train(self, iters: int, generator, loss_fn=None):
        """One train() call as the CLI makes it, its callback included."""
        from cmcd_tpu_torch.train import train
        from cmcd_tpu_torch.utils import MetricLogger, ThroughputMeter

        cfg = self.cfg
        meter, logger = ThroughputMeter(cfg.N, cfg.nbridges), MetricLogger(cfg.log.jsonl)

        def callback(step, info, z):
            info["chain_steps_per_sec"] = meter.chain_rate(info["steps_per_sec"])
            logger.log(info, step=step)

        try:
            return train(self.setup, self.params, self.ctx, lr=cfg.lr, iters=iters,
                         batch_size=cfg.N, generator=generator, trainable=self.trainable,
                         loss_fn=loss_fn or self.loss_fn, use_ema=cfg.use_ema,
                         callback=callback, log_every=cfg.log.every or None,
                         steps_per_call=cfg.steps_per_call)
        finally:
            logger.close()

    def evaluate(self, generator, n_samples: int, groups: int, elbo_fn=None) -> dict:
        """One evaluation request: ELBO and ln Z over `groups` seed groups of
        n_samples chains, and the samples, as the CLI's run_eval makes it."""
        from cmcd_tpu_torch.train import evaluate

        return evaluate(self.params, self.ctx, self.setup, generator=generator,
                        n_samples=n_samples, n_input_dist_seeds=groups,
                        elbo_fn=elbo_fn or self.elbo_fn)
