"""The readings a cell's limits are set from (PERF.md gives them):

  python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \\
      [--control-seeds 1,2,3] [--faults half_batch,altered] [--fault-seeds 1,2,3]

  program  whole runs of the cell (harness.run_cell, a short window) on
           each seed: every number the comparison can make, sound runs;
  control  the reference put in the program's place in the nearest
           precision below the configuration's float32 (TF32 matrix
           products), against the float32 reference, at the cell's size:
           the same first steps, or the same number of requests a run
           checks;
  faults   whole runs with a fault of faults.py planted in the program.

One JSON line per reading, then one summary line: per number the lower
reading (the largest of the program's) and the smallest of the control's
and of each fault's.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def control_numbers(name: str, seed: int, device, overrides=None) -> dict:
    """The control's numbers on one seed: the reference with TF32 matrix
    products against the reference in float32 (overrides: a test's size)."""
    import torch

    from portbench import harness as h

    c = h.override(h.cell(name), overrides)
    run = {"cell": c, "seed": seed, "device": device,
           "reference": h.load_module("reference", c["config"]["name"])}
    weights = h.make_weights(c["config"], seed, device)
    train = c["traffic"]["loop"] == "train"
    requests = list(range(c["traffic"]["checked"]))
    exact = h.reference_train(run, weights) if train else h.reference_eval(run, weights, requests)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        low = (h.reference_train(run, weights) if train
               else h.reference_eval(run, weights, requests))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    if train:
        losses, first, after = low
        kept = {"losses": losses, "first": first, "after": after,
                "trainable": c["config"]["trainable"]}
        return h.compare_train(kept, weights, *exact)
    from portbench.reference.cmcd import summarize

    kept = {}
    for j, ne in low.items():
        elbo, lnz = summarize(ne)
        kept[j] = (ne.numpy(), float(elbo.mean()), float(lnz.mean()))
    return h.compare_eval(kept, exact)


def main(argv=None) -> int:
    import torch

    from portbench import harness as h
    from portbench.faults import FAULTS

    parser = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--faults", default="")
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--seconds", type=float, default=1.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    readings = {}

    def record(kind, seed, numbers, **extra):
        readings.setdefault(kind, []).append(numbers)
        print(json.dumps({"kind": kind, "seed": seed, "numbers": numbers, **extra}), flush=True)

    for seed in _seeds(args.seeds):
        r = h.run_cell(args.workload, seed, args.seconds, False, t_start=time.perf_counter())
        record("program", seed, r["_numbers"], correct=r["correct"], metrics=r["metrics"])
    for seed in _seeds(args.control_seeds):
        record("control", seed, control_numbers(args.workload, seed, device))
    for fault in filter(None, args.faults.split(",")):
        for seed in _seeds(args.fault_seeds):
            r = h.run_cell(args.workload, seed, args.seconds, False, t_start=time.perf_counter(),
                           breaks=FAULTS[fault])
            record(fault, seed, r["_numbers"], correct=r["correct"])
    summary = {}
    for kind, rows in readings.items():
        pick = max if kind == "program" else min
        summary[kind] = {k: pick(row[k] for row in rows) for k in rows[0]}
    if "program" in summary:
        lower = summary["program"]
        summary["ratio_to_lower"] = {
            kind: {k: (v / lower[k] if lower[k] > 0 else math.inf) for k, v in vals.items()}
            for kind, vals in summary.items() if kind != "program"}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
