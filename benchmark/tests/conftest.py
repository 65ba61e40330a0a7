"""Helpers of the benchmark's CPU tests: every cell of BENCHMARK.json at a
tiny size (the configuration's shapes cut, its settings kept), each as its
loop's ``tiny`` sizes it."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


CELLS = tuple(w["name"] for w in bench()["workloads"])


def cells_of(loop: str) -> list:
    """The cells whose traffic mix runs ``loops/<loop>.py``."""
    from benchmark import harness

    return [name for name in CELLS if harness.load_cell(name, bench()).traffic["loop"] == loop]


def tiny_cell(name: str):
    """The cell ``name`` at a size a CPU test holds, as its loop's ``tiny``
    gives it: configuration, traffic, and the limits it overrides."""
    from benchmark import harness

    cell = harness.load_cell(name, bench())
    cell.cfg, cell.traffic, limits = cell.loop.tiny(cell.cfg, cell.traffic)
    cell.limits = dict(cell.limits, **limits)
    return cell


@pytest.fixture
def cuda_card():
    """Skips a test marked ``gpu`` where no CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
