"""Trace a fused training run: evaluation and a gradient check at chosen steps.

    python -m cmcd_tpu_torch.tools.recipe_trace --seeds 1,2 \\
        --checkpoints 0,2000,10000,40000 --grad-checks 2000,40000 \\
        --config.model many_gmm --config.boundmode MCD_CAIS_sn ... --config.iters 40000

Trains the configuration once per seed through train() and the fused loss
main.py would take. Before the optimizer step numbered by each checkpoint
(and after the last step for a checkpoint equal to iters) it prints one JSON
line: the 30 x 500 evaluation at the current parameters (ELBO, ln Z, their
spreads over the seed groups, every group's ln Z, the share of each group's
largest weight), how the samples spread over the target's modes, and the mean
training loss of the last 100 steps. At each step of --grad-checks it also
holds one training step's gradient through the kernels against the same step
through the plain versions in float32 and in float64, per leaf, at the
parameters reached: what a test at the initial parameters cannot see. The
evaluation draws come from their own generator, so tracing changes nothing
in the training run. Runs on the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import sys

import torch

from cmcd_tpu_torch import bounds
from cmcd_tpu_torch.config import apply_lookup_tables
from cmcd_tpu_torch.main import init_experiment, parse_args
from cmcd_tpu_torch.ops import compute_elbos_fused, fused_training_path
from cmcd_tpu_torch.ops.target_grads import score_for_target
from cmcd_tpu_torch.train import evaluate, train
from cmcd_tpu_torch.train.trainer import double_tree, tree_leaf_names, tree_leaves
from cmcd_tpu_torch.utils import resolve_device


def evaluation(params, ctx, setup, target, config, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(config.seed + 1)
    fn = lambda p, n, g: compute_elbos_fused(p, n, setup, target, generator=g)
    out = evaluate(params, ctx, setup, generator=gen, n_samples=config.n_samples,
                   n_input_dist_seeds=config.n_input_dist_seeds, elbo_fn=fn)
    log_w = -torch.as_tensor(out.pop("neg_elbos")).double()        # (S, n)
    ln_z = torch.logsumexp(log_w, dim=1) - math.log(log_w.shape[1])
    out["ln_Z_by_group"] = [round(float(x), 4) for x in ln_z]
    out["largest_weight_share_by_group"] = [
        round(float(x), 4) for x in torch.softmax(log_w, dim=1).max(dim=1).values]
    out["non_finite_log_weights"] = int((~torch.isfinite(log_w)).sum())
    z = torch.as_tensor(out.pop("samples"))
    means = score_for_target(target, "cpu").means
    share = torch.bincount(torch.cdist(z, means).argmin(dim=1), minlength=len(means)) / len(z)
    even = 1.0 / len(means)
    out["modes"] = {"n": len(means), "below_quarter_share": int((share < 0.25 * even).sum()),
                    "min_share_over_even": float(share.min() / even),
                    "max_share_over_even": float(share.max() / even)}
    return out


def gradient_check(params, ctx, setup, target, config, loss_fn, device) -> dict:
    """One step's gradient at `params` with fixed draws: kernels, plain
    versions in float32, plain versions in float64; per leaf the distance of
    the first two from each other and from the third, over the third's norm."""
    gen = torch.Generator(device=device).manual_seed(23)
    draws = dict(base_normals=torch.randn(config.N, setup.dim, generator=gen, device=device),
                 noise=torch.randn(setup.nbridges, config.N, setup.dim, generator=gen,
                                   device=device))

    def grads(tree, cast, **kw):
        leaves = tree_leaves(tree["train"])
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss, _ = loss_fn(tree, config.N, ctx, setup, target, **kw,
                          **{k: cast(v) for k, v in draws.items()})
        out = torch.autograd.grad(loss, leaves, allow_unused=True)
        for leaf in leaves:
            leaf.requires_grad_(False)
        return float(loss.detach()), [None if g is None else g.double() for g in out]

    same = lambda t: t
    tree = {"train": copy.deepcopy(params["train"]), "notrain": params["notrain"]}
    l_k, g_k = grads(tree, same)
    l_p, g_p = grads(tree, same, plain=True)
    l_d, g_d = grads(double_tree(tree), lambda t: t.double(), plain=True)
    rows = []
    for name, k, p, d in zip(tree_leaf_names(tree["train"]), g_k, g_p, g_d):
        if d is None:
            continue
        ref = max(float(d.norm()), 1e-30)
        rows.append({"leaf": name, "norm": ref, "kernel_vs_plain": float((k - p).norm()) / ref,
                     "kernel_vs_f64": float((k - d).norm()) / ref,
                     "plain_vs_f64": float((p - d).norm()) / ref,
                     "clipped_share": float((d.abs() > 5.0).double().mean())})
    flat = lambda g, ref: torch.cat([x.reshape(-1) for x, r in zip(g, ref) if r is not None])
    cos = lambda a, b: float(torch.dot(a, b) / (a.norm() * b.norm()))
    return {"loss": {"kernel": l_k, "plain": l_p, "f64": l_d},
            "cosine_kernel_f64": cos(flat(g_k, g_d), flat(g_d, g_d)),
            "cosine_plain_f64": cos(flat(g_p, g_d), flat(g_d, g_d)),
            "worst_kernel_vs_f64": max(r["kernel_vs_f64"] for r in rows),
            "worst_plain_vs_f64": max(r["plain_vs_f64"] for r in rows), "leaves": rows}


def trace(config, device, checkpoints, grad_checks):
    target, setup, params, ctx = init_experiment(config, device)
    trainable = bounds.default_trainable(setup.mode, config.train_eps, config.train_vi,
                                         config.train_betas)
    fused_loss, path = fused_training_path(setup, config.N)
    print(f"seed {config.seed}: {path}", flush=True)
    state = {"step": 0, "recent": []}

    def report(step, tree):
        line = {"seed": config.seed, "step": step}
        if state["recent"]:
            line["train_loss_last_100"] = float(torch.stack(state["recent"]).mean())
        with torch.no_grad():
            line.update(evaluation(tree, ctx, setup, target, config, device))
        print("[trace] " + json.dumps(line), flush=True)
        if step in grad_checks:
            check = gradient_check(tree, ctx, setup, target, config, fused_loss, device)
            print("[gradient] " + json.dumps({"seed": config.seed, "step": step, **check}),
                  flush=True)

    def loss_fn(p, n, c, s, generator):
        if state["step"] in checkpoints:
            report(state["step"], p)
        state["step"] += 1
        loss, aux = fused_loss(p, n, c, s, target, generator=generator)
        state["recent"] = state["recent"][-99:] + [loss.detach()]
        return loss, aux

    generator = torch.Generator(device=device).manual_seed(config.seed)
    result = train(setup, params, ctx, lr=config.lr, iters=config.iters, batch_size=config.N,
                   generator=generator, trainable=trainable, loss_fn=loss_fn,
                   steps_per_call=config.steps_per_call)
    print(f"seed {config.seed}: steps_done {result.steps_done} diverged {result.diverged}",
          flush=True)
    if config.iters in checkpoints:
        report(config.iters, result.params)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--checkpoints", default="0")
    ap.add_argument("--grad-checks", default="")
    own, rest = ap.parse_known_args(argv)
    ints = lambda text: [int(x) for x in text.split(",") if x]
    config, device = parse_args(rest)
    for k, v in apply_lookup_tables(config).items():
        setattr(config, k, v)
    device = resolve_device(device)
    for seed in ints(own.seeds):
        config.seed = seed
        trace(config, device, set(ints(own.checkpoints)), set(ints(own.grad_checks)))


if __name__ == "__main__":
    main(sys.argv[1:])
