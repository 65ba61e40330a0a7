"""Helpers of the benchmark's CPU tests: every cell of BENCHMARK.json at a
tiny size (the configuration's shapes cut, its settings kept)."""

import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_DATA = dict(n_users=300, m_items=500, n_train=6000, n_test=1500, zipf_s=1.1,
                 structure_seed=5)
CELLS = ("gowalla-train", "amazon-book-eval", "gowalla-serve")


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


# bf16 rounding over the tiny graph and a 2,000-row batch reads up to 1.9e-6,
# 4.5e-4 and 1.3e-4 on the CPU (five seeds), above the limits set from
# readings at the cell's size; these stand in for them at the tiny size
TINY_BF16_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-3, "change_gap": 1e-3}


def tiny_cell(name: str):
    """The cell ``name`` at a size a CPU test holds (bf16 training's limits
    those of the tiny size)."""
    from benchmark import harness

    cell = harness.load_cell(name, bench())
    cell.cfg = copy.deepcopy(cell.cfg)
    cell.traffic = dict(cell.traffic)
    cfg = cell.cfg
    cfg["data"] = dict(TINY_DATA)
    cfg["train"]["batch_size"] = 2000
    cfg["eval"]["test_batch"] = 64
    if cfg["model"].get("spmm_mode") == "tiled":
        cfg["model"].update(tiled_groups=4, tiled_cols=64)
    if cell.traffic["loop"] == "train" and cfg["precision"]["propagation"] == "bfloat16":
        cell.limits = dict(cell.limits, **TINY_BF16_LIMITS)
    if cell.traffic["loop"] == "serve":
        cell.traffic.update(warmup_requests=5, check_requests=20)
    return cell


@pytest.fixture
def cuda_card():
    """Skips a test marked ``gpu`` where no CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
