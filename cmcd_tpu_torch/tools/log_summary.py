"""Summarise the CLI's JSONL metrics logs (--config.log.jsonl).

    python -m cmcd_tpu_torch.tools.log_summary run1.jsonl run2.jsonl

Prints one JSON line per log: the final evaluation (ELBO and ln Z with their
spreads over the seed groups), the median optimizer-step time in ms over the
logged training steps that carry a rate (1e3 / steps_per_sec; None where no
rate was logged), the number of logged steps, the last logged loss and eps,
and the log's wall time. Reads files only; runs anywhere.
"""

from __future__ import annotations

import argparse
import json
import statistics


def summarise(path: str) -> dict:
    """The summary of one log (see the module docstring)."""
    with open(path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    steps = [r for r in records if "step" in r]
    # A rate exists once two host reads of the trainer's chunks have passed.
    rates = [r["steps_per_sec"] for r in steps if r.get("steps_per_sec")]
    final = next((r for r in reversed(records) if "final_elbo" in r), {})
    out = {"log": path, "logged_steps": len(steps)}
    for key in ("final_elbo", "final_elbo_std", "final_ln_Z", "final_ln_Z_std", "wall_time"):
        out[key] = final.get(key)
    out["median_step_ms"] = statistics.median(1e3 / r for r in rates) if rates else None
    if steps:
        out["last_step"] = steps[-1]["step"]
        for key in ("loss", "eps"):
            out[f"last_{key}"] = steps[-1].get(key)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("logs", nargs="+")
    for path in ap.parse_args(argv).logs:
        print(json.dumps(summarise(path)), flush=True)


if __name__ == "__main__":
    main()
