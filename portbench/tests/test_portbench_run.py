"""The run's guards: no card, no result; JAX or the JAX package loaded, no
result; and a whole run of each cell at a small size on the CPU, sound and
then with each fault planted, where `correct` has to come out false.

On the CPU the program runs its kernels' plain twins at a test's size, whose
rounding the cells' limits (set on the card at full size) were not read
from: a sound run here has every number within ten times its limit, and a
fault takes some number past ten times its limit."""

import os
import subprocess
import sys
import time
import types

import pytest

from portbench import harness
from portbench.faults import FAULTS
from portbench.tests.conftest import small

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def test_no_card_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=harness.CHECKOUT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.parametrize("name", ["jax", "jaxlib", "flax", "cmcd_tpu"])
def test_forbidden_module_found(monkeypatch, name):
    monkeypatch.setitem(sys.modules, name + ".sub", types.ModuleType(name + ".sub"))
    assert harness.forbidden_modules() == [name]


def test_port_passes_the_import_check():
    import cmcd_tpu_torch  # noqa: F401

    assert "cmcd_tpu_torch" in sys.modules
    assert harness.forbidden_modules() == []


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_near(cell, trace, cpu):
    r = harness.run_cell(cell, 2**31 + 12345, 0.2, trace, t_start=time.perf_counter(),
                         device=cpu, overrides=small(cell))
    assert max(_ratios(r)) < 10.0, r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-2:] == ["checks", "_numbers"]
    if not trace:
        assert "setup_s" in r["metrics"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(cell, fault, cpu):
    r = harness.run_cell(cell, 77, 0.2, False, t_start=time.perf_counter(), device=cpu,
                         overrides=small(cell), breaks=FAULTS[fault])
    assert not r["correct"] and max(_ratios(r)) > 10.0, r["checks"]


def _ratios(result):
    return [c["value"] / c["limit"] for c in result["checks"].values()]
