"""On the card (marked `chip`): the control, the reference computed with TF32
matrix products in the program's place, has to come out not correct against
each cell's limits at the cell's own size, on three seeds; a sound run at a
held-down size has to come out correct."""

import math
import time

import pytest

from portbench import harness
from portbench.calibrate import control_numbers

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
# Held-down sizes at the configurations' own widths.
SIZES = {"many_gmm_var": {"N": 500, "nbridges": 64},
         "lgcp_k8": {"N": 20, "nbridges": 8}}
TRAFFIC = {"n_samples": 200, "groups": 4, "warmup_requests": 1, "trace_units": 8,
           "diagnose_units": 2, "warmup_steps": 2, "estimate_steps": 4, "chunk": 10}


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, card):
    limits = harness.cell(cell)["limits"]
    for seed in (1, 2, 3):
        numbers = control_numbers(cell, seed, card)
        assert any(not math.isfinite(numbers[k]) or numbers[k] > v for k, v in limits.items()), \
            (seed, numbers)


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_on_card(cell, card):
    sizes = {"flags": SIZES[cell.split(".")[0]], "traffic": TRAFFIC}
    r = harness.run_cell(cell, 4, 0.5, False, t_start=time.perf_counter(), device=card,
                         overrides=sizes)
    assert r["correct"], r["checks"]
