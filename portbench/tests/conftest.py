"""Shared fixtures of the benchmark's tests: a tiny CPU configuration, and
the card for the tests marked ``chip`` (decided here, never at import)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = dict(n_cells=2000, n_plates=10, num_continents=2)


@pytest.fixture(scope="session", autouse=True)
def _threads():
    import torch

    torch.set_num_threads(2)


@pytest.fixture
def tiny_cfg():
    """The configuration of a cell cut to 2,000 cells (CPU tests only)."""
    from portbench.harness import spec

    def make(workload_name):
        bench = spec.load_benchmark()
        cfg = spec.config(bench, spec.workload(bench, workload_name)["config"])
        cfg.update(TINY)
        return cfg

    return make


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
