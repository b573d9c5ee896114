"""Every file a cell reads is found by its name, so a later change adds a
configuration, a traffic mix or a per-layer metric as new files and entries;
BENCHMARK.json keeps to the contract's form."""

import json
import os
import re

import pytest

from portbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(cell):
    c = harness.cell(cell, BENCH)
    config, traffic = c["config"], c["traffic"]
    assert config["name"] == cell.split(".")[0]
    assert traffic["loop"] in harness.LOOPS
    numbers = ({"loss_gap", "loss_gap_first", "grad_gap", "update_gap", "grad_gap_median"}
               if traffic["loop"] == "train" else
               {"elbo_gap", "lnz_gap", "answer_gap", "chain_gap", "elbo_gap_median",
                "lnz_gap_median", "far_share"})
    assert c["limits"] and set(c["limits"]) <= numbers
    work = c["work"].per_unit(config, traffic)
    assert work and all(w["flops"] > 0 and w["launches"] >= 1 for w in work.values())
    reference = harness.load_module("reference", config["name"])
    assert callable(reference.make_target)
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"], "every cell reports a per-layer metric"
    for m in c["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    """A metric reader and a traffic mix added as files, with no edit to the
    harness, load by their names."""
    for kind in ("metrics", "traffic"):
        os.makedirs(tmp_path / kind)
    (tmp_path / "metrics" / "new_metric.train.py").write_text("def read(t):\n    return 1.5\n")
    (tmp_path / "traffic" / "new_mix.json").write_text(json.dumps({"loop": "train"}))
    monkeypatch.setattr(harness, "ROOT", str(tmp_path))
    assert harness.load_module("metrics", "new_metric.train").read(None) == 1.5
    assert harness.load_json("traffic", "new_mix") == {"loop": "train"}


def test_benchmark_json_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        with open(os.path.join(harness.CHECKOUT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    seen = set()
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", seen))
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024
