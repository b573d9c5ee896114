"""The benchmark of cmcd_tpu_torch: one run of one cell.

A cell of BENCHMARK.json names a configuration (configs/<name>.json: the
program's flags, the sizes, how the weights are drawn, the kernels of each
role) and a traffic mix (traffic/<name>.json: the loop and its sizes); its
limits are limits/<cell>.json, each per-layer metric is read by
metrics/<metric>.py and the work counts are work/<config>.py. The harness
finds them all by name, so a new cell is new files and entries.

A run: the weights from the seed on the card, the program set up and warmed
up on the cell's own shapes (set-up), one measured window of the traffic's
loop, then, with the window closed and the program freed, the plain
reference (reference/) over the window's first steps or a sample of its
requests, each compared number beside its limit.
"""

from __future__ import annotations

import gc
import hashlib
import importlib.util
import json
import math
import os
import random
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(ROOT)
# Whole top-level module names that may not be loaded where the result is
# printed: JAX and the JAX package the port was written from.
FORBIDDEN = ("jax", "jaxlib", "flax", "cmcd_tpu")


# A chain's negative ELBO that differs from the reference's by more than
# this share of its size (at least 1 nat) counts as far off (far_share).
FAR = 1e-2


class NoDevice(RuntimeError):
    """The run found fewer cards than the cell asks for."""


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one purpose of a run, from --seed and tags."""
    text = ":".join(str(x) for x in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(ROOT, kind, name + ".json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """portbench/<kind>/<name>.py as a module (a name may hold dots)."""
    path = os.path.join(ROOT, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark() -> dict:
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(name: str, bench: dict | None = None) -> dict:
    """Everything a run of the cell `name` reads, found by name."""
    bench = bench or benchmark()
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    traffic = load_json("traffic", work["traffic"])
    check_traffic(work["traffic"], traffic)
    applies = lambda m: name in m.get("workloads", [name])
    end_to_end = [m for m in bench["end_to_end"] if applies(m)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"] if applies(m) and m["moves"] in reported]
    return {
        "name": name, "chips": work["chips"],
        "config": load_json("configs", work["config"]),
        "traffic": traffic,
        "limits": load_json("limits", name),
        "work": load_module("work", work["config"]),
        "end_to_end": end_to_end, "per_layer": per_layer,
    }


def check_traffic(name: str, traffic: dict):
    """Refuse a traffic mix whose loop the harness lacks, or that holds a
    parameter its loop does not read: a knob nothing serves (several
    clients, say) would be reported and not run."""
    loop = LOOPS.get(traffic.get("loop"))
    if loop is None:
        raise ValueError(f"traffic {name!r}: no loop {traffic.get('loop')!r} "
                         f"(the harness has {sorted(LOOPS)})")
    unread = set(traffic) - set(loop.KEYS) - {"loop", "why"}
    if unread:
        raise ValueError(f"traffic {name!r}: {sorted(unread)} not read by the "
                         f"{traffic['loop']!r} loop, which reads {sorted(loop.KEYS)}")


def override(c: dict, overrides: dict | None) -> dict:
    """The cell with flags and traffic parameters replaced (a test's small
    size: {"flags": {...}, "traffic": {...}})."""
    if overrides:
        c["config"] = {**c["config"], "flags": {**c["config"]["flags"],
                                                **overrides.get("flags", {})}}
        c["traffic"] = {**c["traffic"], **overrides.get("traffic", {})}
    return c


def forbidden_modules() -> list:
    """The FORBIDDEN names that sys.modules holds, by whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def reference_spec(config: dict, n_chains: int):
    from portbench.reference.cmcd import Spec

    f = config["flags"]
    return Spec(dim=config["dim"], n_chains=n_chains, nbridges=f["nbridges"],
                emb_dim=f["emb_dim"], loss=config["loss"], grad_clipping=f["grad_clipping"])


def make_weights(config: dict, seed: int, device) -> dict:
    """Every parameter of the configuration, drawn from the seed on `device`
    in one call of each kind: the net glorot-normal (biases and the
    embedding normal), its output scale uniform in the configuration's
    range, the start's mean around its centre, the step size and the
    spline knots as the recipe initialises them."""
    import torch

    f, w = config["flags"], config["weights"]
    dim, emb, k = config["dim"], f["emb_dim"], f["nbridges"]
    width = dim + emb
    shapes = {"W1": (width, width), "b1": (width,), "W2": (width, width), "b2": (width,),
              "Wh": (dim, width), "bh": (dim,), "emb": (k, emb), "vd_mean": (dim,)}
    sd = {"W1": math.sqrt(1.0 / width), "W2": math.sqrt(1.0 / width),
          "Wh": math.sqrt(2.0 / (width + dim)), "b1": w["bias_sd"], "b2": w["bias_sd"],
          "bh": w["bias_sd"], "emb": w["emb_sd"], "vd_mean": w["vd_mean_sd"]}
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(sum(math.prod(s) for s in shapes.values()), generator=g, device=device)
    u = torch.rand(1, generator=g, device=device)
    out, at = {}, 0
    for key, shape in shapes.items():
        size = math.prod(shape)
        out[key] = flat[at:at + size].view(shape) * sd[key]
        at += size
    out["vd_mean"] = out["vd_mean"] + w["vd_mean"]
    lo, hi = w["factor"]
    out["factor"] = (lo + (hi - lo) * u).reshape(())
    out["vd_logdiag"] = torch.full((dim,), math.log(w["vd_sigma"]), device=device)
    out["eps"] = torch.tensor(float(f["init_eps"]), device=device)
    out["knots"] = torch.ones(min(32, k) + 1, device=device)
    return out


def draw_group(generator, n: int, dim: int, device):
    """One seed group's inputs as the program draws them from its generator:
    the start's standard normals (n, dim), then the kernel's Philox seed."""
    import torch

    base = torch.randn((n, dim), generator=generator, device=device)
    seed = torch.randint(2**31 - 1, (1,), generator=generator, device=device)
    return base, int(seed)


def step_noise(seeds, n: int, k: int, dim: int, device):
    """The K step draws (K, S * n, dim) of seed groups with these seeds, as
    the program makes them: the kernel's Philox stream on the card; on the
    CPU, where the program runs its kernels' plain versions, torch.randn
    from a CPU generator seeded with the seed, step after step."""
    import torch

    if device.type == "cuda":
        from portbench.reference.philox import philox_normals

        parts = [philox_normals([s], n, range(k), dim, device)[0] for s in seeds]
    else:
        parts = []
        for s in seeds:
            g = torch.Generator().manual_seed(int(s))
            parts.append(torch.stack([torch.randn((n, dim), generator=g) for _ in range(k)]))
    return torch.cat(parts, dim=1)


def gap(a, b):
    """|a - b| elementwise, 0 where both are the same infinity."""
    import torch

    same = a == b
    return torch.where(same, torch.zeros_like(a), (a - b).abs())


class StepProbe:
    """The first steps of a train() call, read through torch.optim's global
    step hooks: the gradients as Adam got them (its first moment after step
    1 over 1 - b1) and the parameters step `checked + 1` starts from."""

    def __init__(self, checked: int):
        from torch.optim.optimizer import (
            register_optimizer_step_post_hook,
            register_optimizer_step_pre_hook,
        )

        self.checked, self.calls = checked, 0
        self.first = self.after = None
        self.handles = [register_optimizer_step_pre_hook(self._pre),
                        register_optimizer_step_post_hook(self._post)]

    def _pre(self, opt, args, kwargs):
        self.calls += 1
        if self.calls == self.checked + 1:
            self.after = [p.detach().clone() for p in opt.param_groups[0]["params"]]

    def _post(self, opt, args, kwargs):
        if self.calls == 1:
            b1 = opt.param_groups[0]["betas"][0]
            self.first = [opt.state[p]["exp_avg"] / (1.0 - b1) if "exp_avg" in opt.state.get(p, {})
                          else None for p in opt.param_groups[0]["params"]]

    def remove(self):
        for h in self.handles:
            h.remove()


class TrainLoop:
    """Closed loop of optimizer steps: one train() call, as the CLI makes it,
    with iters sized from the warm-up to fill the window (a multiple of the
    trainer's host-check chunk)."""

    KEYS = ("warmup_steps", "estimate_steps", "chunk", "trace_units", "diagnose_units",
            "checked")

    def __init__(self, prog, run):
        self.prog, self.run = prog, run
        self.traffic = run["cell"]["traffic"]

    def warm_up(self):
        import torch

        g = torch.Generator(device=self.run["device"]).manual_seed(
            sub_seed(self.run["seed"], "warm-up"))
        self.prog.train(self.traffic["warmup_steps"], g)
        sync(self.run["device"])
        self.run["phase"](f"first {self.traffic['warmup_steps']} steps")
        n = self.traffic["estimate_steps"]
        t0 = time.perf_counter()
        self.prog.train(n, g)
        sync(self.run["device"])
        self.step_s = (time.perf_counter() - t0) / n

    def window(self, seconds: float, trace: bool):
        import torch

        chunk, checked = self.traffic["chunk"], self.traffic["checked"]
        iters = (self.traffic["trace_units"] if trace
                 else chunk * max(1, round(seconds / (self.step_s * chunk))))
        g = torch.Generator(device=self.run["device"]).manual_seed(sub_seed(self.run["seed"], "train"))
        losses = []

        def loss_fn(p, n, c, s, generator):
            out = self.prog.loss_fn(p, n, c, s, generator=generator)
            if len(losses) < checked:
                losses.append(out[0].detach())
            return out

        probe = StepProbe(checked)
        try:
            sync(self.run["device"])
            t0 = time.perf_counter()
            result = self.prog.train(iters, g, loss_fn=loss_fn)
            sync(self.run["device"])
            wall = time.perf_counter() - t0
        finally:
            probe.remove()
        done = result.steps_done
        self.units, self.attempted, self.failed = max(done, 1), iters, iters - done
        self.wall = wall
        names = self.prog.leaf_names()
        self.kept = {
            "losses": [float(x) for x in losses],
            "first": {k: g_ for k, g_ in zip(names, probe.first or []) if k and g_ is not None},
            "after": {k: p for k, p in zip(names, probe.after or []) if k},
            "trainable": [k for k in names if k],
        }
        return {"train_step_ms": 1e3 * wall / self.units}

    def diagnose(self):
        """More steps after the window, on draws of their own (the traced
        run's host-side breakdown)."""
        import torch

        g = torch.Generator(device=self.run["device"]).manual_seed(
            sub_seed(self.run["seed"], "diagnose"))
        self.prog.train(self.traffic["diagnose_units"], g)
        sync(self.run["device"])

    def check(self, weights: dict) -> dict:
        return compare_train(self.kept, weights, *reference_train(self.run, weights))


def reference_train(run: dict, weights: dict):
    """The reference over the window's first `checked` steps, from the same
    weights and the same draws: (losses, first clipped gradients by leaf,
    parameters after the last of them)."""
    import torch

    from portbench.reference import cmcd

    config, device = run["cell"]["config"], run["device"]
    spec = reference_spec(config, config["flags"]["N"])
    target = run["reference"].make_target(device)
    g = torch.Generator(device=device).manual_seed(sub_seed(run["seed"], "train"))

    def draws():
        for _ in range(run["cell"]["traffic"]["checked"]):
            base, s = draw_group(g, spec.n_chains, spec.dim, device)
            xi = step_noise([s], spec.n_chains, spec.nbridges, spec.dim, device)
            yield base, (lambda i, xi=xi: xi[i])

    return cmcd.train_steps(weights, config["trainable"], target, spec, config["flags"]["lr"],
                            draws())


def compare_train(kept: dict, weights: dict, losses, first, after) -> dict:
    """The training numbers of the first steps kept from a run against the
    reference's (losses, first gradients, parameters after). loss_gap: the
    worst relative gap of a step's loss; grad_gap: of a leaf's first
    gradient norm; update_gap: of a leaf's change over the steps (leaves
    whose reference gradient is under 1e-3 of the median leaf's left out);
    each leaf's gap over the larger of its reference norm and the median
    leaf's. loss_gap_first: the first step's alone, where Adam's steps
    amplify round-off (PERF.md); grad_gap_median: the median leaf's gap,
    where one small leaf's round-off sets the worst."""
    import torch

    n = min(len(losses), len(kept["losses"]))
    if n == 0 or not kept["first"] or not kept["after"] or set(kept["trainable"]) != set(first):
        return dict.fromkeys(("loss_gap", "loss_gap_first", "grad_gap", "update_gap",
                              "grad_gap_median"), math.inf)
    gaps = [abs(kept["losses"][i] - losses[i]) / max(abs(losses[i]), 1e-30) for i in range(n)]
    loss_gap = max(gaps)
    if len(kept["losses"]) < len(losses):
        loss_gap = math.inf
    norm = lambda t: float(torch.linalg.vector_norm(t.double()))
    leaves = [k for k in kept["trainable"] if k in first]
    g_ref = {k: norm(first[k]) for k in leaves}
    g_med = sorted(g_ref.values())[len(leaves) // 2]
    grads = [abs(norm(kept["first"][k]) - g_ref[k]) / max(g_ref[k], g_med, 1e-30)
             if k in kept["first"] else math.inf for k in leaves]
    moved = [k for k in leaves if g_ref[k] >= 1e-3 * g_med]
    d_ref = {k: norm(after[k] - weights[k]) for k in moved}
    d_med = sorted(d_ref.values())[len(moved) // 2]
    updates = [abs(norm(kept["after"][k] - weights[k]) - d_ref[k]) / max(d_ref[k], d_med, 1e-30)
               for k in moved]
    return {"loss_gap": loss_gap, "loss_gap_first": gaps[0],
            "grad_gap": max(grads), "update_gap": max(updates),
            "grad_gap_median": sorted(grads)[len(grads) // 2]}


class EvalLoop:
    """Closed loop of evaluation requests from one client: each request is
    train.evaluate over `groups` seed groups of `n_samples` chains, its own
    draws from a generator seeded for it, timed from its call until it
    returns (its host reads wait for the card)."""

    KEYS = ("groups", "n_samples", "warmup_requests", "trace_units", "diagnose_units",
            "checked")

    def __init__(self, prog, run):
        self.prog, self.run = prog, run
        self.traffic = run["cell"]["traffic"]

    def _request(self, g, j, tag="request"):
        g.manual_seed(sub_seed(self.run["seed"], tag, j))
        t = self.traffic
        return self.prog.evaluate(g, t["n_samples"], t["groups"])

    def warm_up(self):
        import torch

        g = torch.Generator(device=self.run["device"])
        for j in range(self.traffic["warmup_requests"]):
            g.manual_seed(sub_seed(self.run["seed"], "warm-up", j))
            self.prog.evaluate(g, self.traffic["n_samples"], self.traffic["groups"])
            self.run["phase"](f"warm-up request {j}")

    def window(self, seconds: float, trace: bool):
        import torch

        g = torch.Generator(device=self.run["device"])
        times, outs = [], []
        sync(self.run["device"])
        t_open = time.perf_counter()
        while True:
            t = time.perf_counter()
            out = self._request(g, len(times))
            t_end = time.perf_counter()
            times.append(t_end - t)
            outs.append((out["neg_elbos"], out["final_elbo"], out["final_ln_Z"]))
            del out
            if (len(times) >= self.traffic["trace_units"]) if trace else (t_end - t_open >= seconds):
                break
        self.wall = t_end - t_open
        self.units = self.attempted = len(times)
        self.failed = sum(1 for ne, _, _ in outs if ne.shape != (self.traffic["groups"],
                                                                  self.traffic["n_samples"]))
        rng = random.Random(sub_seed(self.run["seed"], "sample"))
        picked = [0] + sorted(rng.sample(range(1, len(outs)),
                                         min(self.traffic["checked"] - 1, len(outs) - 1)))
        self.kept = {j: outs[j] for j in picked}
        ordered = sorted(times)
        p95 = ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]
        return {"eval_ms": 1e3 * self.wall / self.units, "eval_p95_ms": 1e3 * p95}

    def diagnose(self):
        """More requests after the window, on draws of their own (the traced
        run's host-side breakdown)."""
        import torch

        g = torch.Generator(device=self.run["device"])
        for j in range(self.traffic["diagnose_units"]):
            self._request(g, j, "diagnose")

    def check(self, weights: dict) -> dict:
        return compare_eval(self.kept, reference_eval(self.run, weights, list(self.kept)))


def reference_eval(run: dict, weights: dict, requests) -> dict:
    """The reference's negative ELBOs (groups, n_samples) of these requests,
    from the same weights and draws, all groups of a request in one batch."""
    import torch

    from portbench.reference import cmcd

    t, config, device = run["cell"]["traffic"], run["cell"]["config"], run["device"]
    n, groups = t["n_samples"], t["groups"]
    spec = reference_spec(config, n * groups)
    target = run["reference"].make_target(device)
    g = torch.Generator(device=device)
    out = {}
    for j in requests:
        g.manual_seed(sub_seed(run["seed"], "request", j))
        draws = [draw_group(g, n, spec.dim, device) for _ in range(groups)]
        base = torch.cat([b for b, _ in draws])
        xi = step_noise([s for _, s in draws], n, spec.nbridges, spec.dim, device)
        with torch.no_grad():
            ne, _ = cmcd.neg_elbos(weights, target, spec, base, lambda i: xi[i])
        out[j] = ne.view(groups, n).double().cpu()
        del xi, base
    return out


def compare_eval(kept: dict, ref: dict) -> dict:
    """The evaluation numbers of the requests kept from a run, each
    (negative ELBOs (groups, n), ELBO, ln Z), against the reference's
    negative ELBOs. elbo_gap, lnz_gap: the widest gap of a seed group's ELBO
    and ln Z, and *_median the median seed group's; answer_gap: of a
    request's ELBO and ln Z as returned; chain_gap: of a chain's negative
    ELBO, over its size (at least 1); far_share: the share of chains whose
    gap so measured passes FAR."""
    import torch

    from portbench.reference import cmcd

    out = {"elbo_gap": 0.0, "lnz_gap": 0.0, "answer_gap": 0.0, "chain_gap": 0.0,
           "elbo_gap_median": 0.0, "lnz_gap_median": 0.0}
    far = total = 0
    for j, (ne_prog, elbo_prog, lnz_prog) in kept.items():
        ne_p = torch.as_tensor(ne_prog).double()
        elbo_r, lnz_r = cmcd.summarize(ref[j])
        elbo_p, lnz_p = cmcd.summarize(ne_p)
        chain = gap(ne_p, ref[j]) / ref[j].abs().clamp(min=1.0)
        far, total = far + int((~(chain <= FAR)).sum()), total + chain.numel()
        out["chain_gap"] = max(out["chain_gap"], float(chain.max()))
        for key, a, b in (("elbo", elbo_p, elbo_r), ("lnz", lnz_p, lnz_r)):
            g = gap(a, b)
            out[key + "_gap"] = max(out[key + "_gap"], float(g.max()))
            out[key + "_gap_median"] = max(out[key + "_gap_median"], float(g.median()))
        answer = gap(torch.tensor([elbo_prog, lnz_prog], dtype=torch.float64),
                     torch.stack([elbo_r.mean(), lnz_r.mean()]))
        out["answer_gap"] = max(out["answer_gap"], float(answer.max()))
    out["far_share"] = far / max(total, 1)
    return {k: (math.inf if math.isnan(v) else v) for k, v in out.items()}


LOOPS = {"train": TrainLoop, "evaluate": EvalLoop}


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_kind(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 and proc.stdout else None


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, t_start: float,
             device=None, overrides=None, breaks=None) -> dict:
    """One run of the cell; returns the result line's object. device: the
    card unless a test passes the CPU; overrides: flags replacing the
    configuration's and the traffic's ({"flags": {...}, "traffic": {...}}:
    a test's small size); breaks(prog): a test's fault,
    planted in the program after its set-up."""
    import torch

    # One process, few threads: the host's share of a step is steadier.
    torch.set_num_threads(2)

    def phase(what):
        print(f"setup {what} {time.perf_counter() - t_start:.3f} s", file=sys.stderr, flush=True)

    phase("torch imported")
    c = cell(name)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < c["chips"]:
            raise NoDevice(f"{name} needs {c['chips']} CUDA device(s); "
                           f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    override(c, overrides)

    from portbench.program import Program

    run = {"cell": c, "seed": seed, "device": device, "phase": phase,
           "reference": load_module("reference", c["config"]["name"])}
    weights = make_weights(c["config"], seed, device)
    sync(device)
    phase("weights drawn")
    prog = Program(c["config"], {k: v.clone() for k, v in weights.items()}, device)
    if breaks is not None:
        breaks(prog)
    sync(device)
    phase("program built")
    loop = LOOPS[c["traffic"]["loop"]](prog, run)
    loop.warm_up()
    sync(device)
    setup_s = time.perf_counter() - t_start
    phase("warmed up")

    prof = diag = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from portbench import trace as tr

        # The metrics' window records device activity alone, so the host
        # runs as it does untraced; a second, shorter window records the
        # host's ops too, for the breakdown of the idle gaps alone.
        on_card = [ProfilerActivity.CUDA] if device.type == "cuda" else []
        with profile(activities=on_card or [ProfilerActivity.CPU]) as prof:
            measured = loop.window(seconds, True)
        with profile(activities=[ProfilerActivity.CPU] + on_card) as diag:
            with record_function(tr.WINDOW):
                loop.diagnose()
    else:
        measured = loop.window(seconds, False)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    del prog, loop.prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = loop.check(weights)
    limits = c["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = loop.failed == 0 and all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
                                       for v in checks.values())

    result = {"correct": correct, "attempted": loop.attempted, "failed": loop.failed}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": device_kind(device), "count": 1 if device.type == "cuda" else 0,
           "memory_peak_bytes": memory_peak}
    if trace:
        records, busy_s, ops = tr.reduce_window(prof)
        gaps = tr.idle_gaps(diag)
        window_s = loop.wall
        del prof, diag
        peaks = load_json("", "peaks").get(dev["kind"])
        t = tr.Trace(records=records, window_s=window_s, busy_s=busy_s, units=loop.units,
                     work=c["work"].per_unit(c["config"], c["traffic"]),
                     kernels=c["config"]["kernels"], peaks=peaks)
        metrics = {}
        for m in c["per_layer"]:
            value = load_module("metrics", m["name"]).read(t)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=busy_s, window_s=window_s)
        if device.type == "cuda":
            dev["power"] = power_limit()
        result["breakdown"] = {"device_ops": ops, "idle_gaps": gaps}
    else:
        measured["setup_s"] = setup_s
        metrics = {m["name"]: {"value": measured[m["name"]], "unit": m["unit"]}
                   for m in c["end_to_end"]}
    result["metrics"] = metrics
    result["device"] = dev
    result["checks"] = checks
    result["_numbers"] = numbers
    return result


def main(argv=None, t_start: float | None = None, t_python: float | None = None) -> int:
    """t_start: the process's start, t_python: the first line of run.py
    (perf_counter); the set-up's first phase is the interpreter's start."""
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    if t_python is not None:
        print(f"setup python started {t_python - t_start:.3f} s", file=sys.stderr, flush=True)
    parser = argparse.ArgumentParser(prog="python3 -m portbench.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=t_start)
    except NoDevice as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    result.pop("_numbers")
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    print(f"correct {result['correct']}", file=sys.stderr)
    for key, check in result["checks"].items():
        print(f"check {key} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
