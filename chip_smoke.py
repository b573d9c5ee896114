#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cmcd_tpu_torch) once on one NVIDIA H100.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --phases 1,2,3

Phases, one line each; any failure exits non-zero:
  1. device: needs CUDA (no CPU run); prints the card's name and power limit.
  2. build: compiles csrc/overdamped.cu with nvcc for sm_90a (ptxas report).
  3. kernel vs plain twin under injected noise, at the CPU tests' size and
     at full width (K=256, emb_dim 130, grad clipping, factor_sn 0.3, random
     embedding) for N=2000 and for the main path's N=500, whose last block
     holds 4 live and 4 idle chains; fails above the stated tolerances.
  4. main path: cmcd_tpu_torch.main.run_experiment with the flagship flags
     (many_gmm, MCD_CAIS_var_sn, K=256, emb_dim 130, iters 0) and the 30 x 500
     evaluation; the kernel must be launched 30 times, ELBO and ln Z finite.
  5. statistics: the same evaluation with the kernel's Philox noise and with
     the plain twin's torch.randn noise agree within 4 combined standard
     errors in ELBO and ln Z.
  6. timing: kernel and plain twin for one K=256 rollout at N=500 (the main
     path's shape) and N=2000 (CUDA events) and for one 30 x 500 evaluation
     (host clock around synchronize), in the order plain, kernel, kernel,
     plain; then the kernel evaluation's device time under torch.profiler.
Then a JSON line with the kernel's launches, error and times, and as the last
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

FLAGSHIP = (
    "--config.model many_gmm --config.boundmode MCD_CAIS_var_sn "
    "--config.N 2000 --config.nbridges 256 --config.emb_dim 130 "
    "--config.init_eps 0.65 --config.init_sigma 15 --config.grad_clipping True "
    "--config.train_eps False --config.train_vi False --config.iters 0 "
    "--noconfig.pretrain_mfvi --config.n_samples 500 --config.n_input_dist_seeds 30"
).split()

# Kernel vs plain twin under the same noise. Small size: the CPU tests'
# tolerance. Full width (K=256): the two sum the 132-wide products in
# different orders and 256 steps compound it, so w (|w| ~ 1e3) gets an
# absolute floor; both limits sit a few times above what an H100 gave at
# N=2000 (z 9.5e-6 abs; w 5.9e-3 abs, 5.3e-6 rel; PERF.md).
TOL_SMALL = {"z_atol": 2e-4, "z_rtol": 1e-4, "w_atol": 5e-4, "w_rtol": 1e-4}
TOL_FULL = {"z_atol": 1e-4, "z_rtol": 0.0, "w_atol": 2e-2, "w_rtol": 1e-5}


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: chip_smoke.py runs on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[1 device] {torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()} torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    return smi


def phase_build():
    from cmcd_tpu_torch.ops import build
    from cmcd_tpu_torch.ops.overdamped import _library

    t0 = time.perf_counter()
    so = build.build("overdamped")
    _library()
    secs = time.perf_counter() - t0
    with open(so[:-3] + ".log") as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    print(f"[2 build] {secs:.2f} s {os.path.relpath(so)} | " + " | ".join(ptxas), flush=True)


def make_problem(n, k, emb_dim, *, seed, factor_sn=0.3, sigma=3.0, eps=0.1):
    """Inputs from a numpy seed: net weights (JAX layout, converted), z0, w0,
    non-uniform betas, noise."""
    from cmcd_tpu_torch.ops.target_grads import make_many_gmm_score
    from cmcd_tpu_torch.schedules import betas_from_grid, make_beta_grid_params
    from cmcd_tpu_torch.utils.convert import geffner_from_jax

    rng = np.random.default_rng(seed)
    in_dim = 2 + emb_dim
    dense = lambda i, o: {"w": rng.normal(0, math.sqrt(2 / (i + o)), (i, o)),
                          "b": rng.normal(0, 1e-2, o)}
    tree = {"layers": [dense(in_dim, in_dim), dense(in_dim, in_dim)],
            "head": dense(in_dim, 2), "emb": rng.normal(0, 1.0, (k, emb_dim)),
            "factor_sn": np.float32(factor_sn)}
    dev = torch.device("cuda")
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    mg, gx, tx = make_beta_grid_params(k, device=dev)
    mg = f32(rng.uniform(0.5, 1.5, mg.shape[0]))
    return dict(
        z0=f32(sigma * rng.standard_normal((n, 2))),
        w0=f32(rng.standard_normal(n)),
        betas=betas_from_grid(mg, gx, tx).contiguous(),
        eps=f32(eps),
        vd_mean=f32([0.5, -0.5]),
        vd_logdiag=f32([math.log(sigma)] * 2),
        grad_logp=make_many_gmm_score(dev),
        sn=geffner_from_jax(tree, dev),
        noise=f32(rng.standard_normal((k, n, 2))),
        dim=2,
        nbridges=k,
    )


def compare(case, spec, tol, **kw):
    from cmcd_tpu_torch.ops.overdamped import (
        evolve_overdamped_fused,
        evolve_overdamped_fused_plain,
    )

    args = dict(case)
    pos = [args.pop(a) for a in ("z0", "w0", "betas", "eps", "vd_mean", "vd_logdiag", "grad_logp")]
    z_k, w_k = evolve_overdamped_fused(*pos, spec, **args, **kw)
    z_p, w_p = evolve_overdamped_fused_plain(*pos, spec, **args, **kw)
    torch.cuda.synchronize()
    dz, dw = (z_k - z_p).abs(), (w_k - w_p).abs()
    bad_z = dz > tol["z_atol"] + tol["z_rtol"] * z_p.abs()
    bad_w = dw > tol["w_atol"] + tol["w_rtol"] * w_p.abs()
    stats = {
        "z_max_abs": float(dz.max()),
        "z_max_rel": float((dz / z_p.abs().clamp_min(1e-6)).max()),
        "w_max_abs": float(dw.max()),
        "w_max_rel": float((dw / w_p.abs().clamp_min(1e-6)).max()),
        "z_bad": int(bad_z.any(-1).sum()),
        "w_bad": int(bad_w.sum()),
        "finite": bool(torch.isfinite(z_k).all() and torch.isfinite(w_k).all()),
    }
    return stats, not (stats["z_bad"] or stats["w_bad"]) and stats["finite"]


def phase_compare():
    from cmcd_tpu_torch.integrators.overdamped import CAIS, CAIS_VAR

    small = make_problem(256, 8, 16, seed=0)
    ok = True
    for name, spec, kw in (
        ("CAIS_VAR", CAIS_VAR, dict(grad_clipping=True)),
        ("CAIS_VAR cos_sq", CAIS_VAR, dict(grad_clipping=True, eps_schedule="cos_sq")),
        ("CAIS", CAIS, dict(grad_clipping=True, eps_schedule="linear")),
        ("CAIS_VAR noclip", CAIS_VAR, dict(grad_clipping=False)),
    ):
        stats, good = compare(small, spec, TOL_SMALL, **kw)
        ok &= good
        print(f"[3 compare] small N=256 K=8 emb16 {name}: {json.dumps(stats)}", flush=True)
    max_err = 0.0
    for n, seed in ((2000, 1), (500, 5)):
        full = make_problem(n, 256, 130, seed=seed, sigma=15.0, eps=0.65)
        stats, good = compare(full, CAIS_VAR, TOL_FULL, grad_clipping=True)
        ok &= good
        max_err = max(max_err, stats["z_max_abs"], stats["w_max_abs"])
        print(f"[3 compare] full N={n} K=256 emb130 CAIS_VAR: {json.dumps(stats)} "
              f"tol {json.dumps(TOL_FULL)}", flush=True)
    if not ok:
        fail("kernel and plain twin disagree beyond tolerance")
    return max_err


def flagship():
    """(config, setup, target, params, ctx) as main.run_experiment builds
    them for the flagship flags."""
    from cmcd_tpu_torch.main import init_experiment, parse_flags

    cfg = parse_flags(FLAGSHIP)
    target, setup, params, ctx = init_experiment(cfg, torch.device("cuda"))
    return cfg, setup, target, params, ctx


def phase_main_path():
    from cmcd_tpu_torch.main import parse_flags, run_experiment
    from cmcd_tpu_torch.ops.overdamped import evolve_overdamped_fused

    cfg = parse_flags(FLAGSHIP)
    evolve_overdamped_fused.launches = 0
    t0 = time.perf_counter()
    out = run_experiment(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = evolve_overdamped_fused.launches
    print(f"[4 main path] ELBO {out['final_elbo']!r} +- {out['final_elbo_std']!r} "
          f"ln Z {out['final_ln_Z']!r} +- {out['final_ln_Z_std']!r} launches {launches} "
          f"wall {wall:.3f} s samples {out['samples'].shape}", flush=True)
    if launches != cfg.n_input_dist_seeds:
        fail(f"main path launched the kernel {launches} times, expected "
             f"{cfg.n_input_dist_seeds}")
    if not (math.isfinite(out["final_elbo"]) and math.isfinite(out["final_ln_Z"])):
        fail("main path ELBO / ln Z not finite")
    if out["neg_elbos"].shape != (30, 500) or out["samples"].shape != (15000, 2):
        fail(f"main path shapes {out['neg_elbos'].shape} {out['samples'].shape}")
    if not np.isfinite(out["samples"]).all():
        fail("main path samples not finite")
    return launches


def _evaluate(state, rollout, seed):
    """One 30 x 500 evaluation of the flagship params through `rollout`."""
    from cmcd_tpu_torch.ops.fused import compute_elbos_fused
    from cmcd_tpu_torch.train import evaluate

    cfg, setup, target, params, ctx = state
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fn = lambda p, n, g: compute_elbos_fused(p, n, setup, target, generator=g, rollout=rollout)
    return evaluate(params, ctx, setup, generator=gen, n_samples=cfg.n_samples,
                    n_input_dist_seeds=cfg.n_input_dist_seeds, elbo_fn=fn)


def phase_statistics():
    from cmcd_tpu_torch.ops.overdamped import (
        evolve_overdamped_fused,
        evolve_overdamped_fused_plain,
    )

    state = flagship()
    k = _evaluate(state, evolve_overdamped_fused, seed=11)
    p = _evaluate(state, evolve_overdamped_fused_plain, seed=12)
    line = {}
    ok = True
    for key in ("final_elbo", "final_ln_Z"):
        se = math.hypot(k[key + "_std"], p[key + "_std"]) / math.sqrt(30)
        z = abs(k[key] - p[key]) / se
        line[key] = {"kernel": k[key], "plain": p[key], "combined_se": se, "z": z}
        ok &= z <= 4.0
    print(f"[5 statistics] {json.dumps(line)}", flush=True)
    if not ok:
        fail("Philox kernel and torch.randn plain evaluations differ by > 4 SE")


def _event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _profile(fn):
    """Device time over one call of fn (torch.profiler), read from the
    device's own records only (kernels, memcpy, memset); the CPU op that
    launched a kernel carries the same time again, so CPU rows are left out.
    Returns (wall ms under the profiler, busy ms as the union of the device
    intervals, the device records [name, ms, count] by time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _wall_ms(fn)
    records = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, reach = 0.0, -math.inf
    by_name = {}
    for start, end, name in records:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        ms, count = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (end - start) / 1e3, count + 1)
    top = sorted(([n[:60], ms, c] for n, (ms, c) in by_name.items()), key=lambda r: -r[1])
    return wall, busy_us / 1e3, top[:6]


def phase_timing():
    from cmcd_tpu_torch.integrators.overdamped import CAIS_VAR
    from cmcd_tpu_torch.ops.overdamped import (
        evolve_overdamped_fused,
        evolve_overdamped_fused_plain,
    )

    rollout = {}
    for n in (500, 2000):
        case = make_problem(n, 256, 130, seed=2, sigma=15.0, eps=0.65)
        case.pop("noise")
        pos = [case.pop(a) for a in ("z0", "w0", "betas", "eps", "vd_mean", "vd_logdiag",
                                     "grad_logp")]
        seed = torch.tensor([7], device="cuda")
        kern = lambda: evolve_overdamped_fused(*pos, CAIS_VAR, **case, grad_clipping=True,
                                               seed=seed)
        plain = lambda: evolve_overdamped_fused_plain(*pos, CAIS_VAR, **case,
                                                      grad_clipping=True, seed=7)
        times = rollout[f"N{n}"] = {"plain": [], "kernel": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            fn, reps = (plain, 2) if name == "plain" else (kern, 20)
            times[name].append(_event_ms(fn, reps))
    state = flagship()
    evals = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        r = evolve_overdamped_fused_plain if name == "plain" else evolve_overdamped_fused
        evals[name].append(_wall_ms(lambda: _evaluate(state, r, seed=3)))
    prof_wall, prof_dev, top = _profile(lambda: _evaluate(state, evolve_overdamped_fused, 4))
    print(f"[6 timing] rollout K=256 ms {json.dumps(rollout)} | "
          f"evaluate 30x500 ms {json.dumps(evals)}", flush=True)
    print(f"[6 profile] kernel evaluate 30x500: wall {prof_wall!r} ms under the "
          f"profiler, device busy {prof_dev!r} ms ({100 * prof_dev / prof_wall!r}%), "
          f"device records [name, ms, count] {json.dumps(top)}; busy over the "
          f"fastest unprofiled kernel evaluate {100 * prof_dev / min(evals['kernel'])!r}%",
          flush=True)
    return min(rollout["N500"]["kernel"]), min(rollout["N500"]["plain"]), evals


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6",
                    help="comma-separated phases to run (default: all)")
    phases = {int(p) for p in ap.parse_args(argv).phases.split(",")}
    smi = phase_device()
    phase_build()
    max_err = phase_compare() if 3 in phases else None
    launches = phase_main_path() if 4 in phases else None
    if 5 in phases:
        phase_statistics()
    timing = phase_timing() if 6 in phases else None
    if phases != {1, 2, 3, 4, 5, 6}:
        print(f"partial run (phases {sorted(phases)}): no result line")
        return 1
    kernel_ms, plain_ms, _ = timing
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "overdamped_rollout",
        "route": "cuda",
        "source": "cmcd_tpu_torch/csrc/overdamped.cu",
        "replaces": "cmcd_tpu/ops/pallas_overdamped.py:102",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
