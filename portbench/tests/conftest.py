"""The benchmark's own tests: on the CPU at small sizes, and, marked `chip`,
on an NVIDIA card (python3 -m pytest portbench/tests -m chip runs those)."""

import pytest
import torch

from portbench import harness

# The small sizes the CPU tests run each configuration at.
SMALL = {"many_gmm_var": {"N": 16, "nbridges": 4, "emb_dim": 6},
         "lgcp_k8": {"N": 4, "nbridges": 2}}
# Cells whose files stay under portbench/ while BENCHMARK.json holds them back
# (PERF.md, Open questions): their reference and work counts are still tested.
HELD_BACK = [{"name": "many_gmm_var.train", "config": "many_gmm_var", "traffic": "train",
              "chips": 1}]
SMALL_TRAFFIC = {"n_samples": 8, "groups": 2, "warmup_requests": 1, "trace_units": 8,
                 "diagnose_units": 2, "warmup_steps": 2, "estimate_steps": 2, "chunk": 4}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card; skipped without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CPU-only PyTorch sees none)")
    return torch.device("cuda", 0)


@pytest.fixture
def cpu():
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return torch.device("cpu")


def small(cell_name: str) -> dict:
    return {"flags": SMALL[cell_name.split(".")[0]], "traffic": SMALL_TRAFFIC}


def any_cell(name: str) -> dict:
    """A cell of BENCHMARK.json or one held back, by name."""
    bench = harness.benchmark()
    return harness.cell(name, {**bench, "workloads": bench["workloads"] + HELD_BACK})
