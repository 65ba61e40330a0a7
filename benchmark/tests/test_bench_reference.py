"""The reference against the port, through the harness's own entry points,
on the CPU at a tiny size: every cell runs, traced and untraced, and comes
out correct; the reference's pieces agree with plain arithmetic."""

import numpy as np
import pytest
import torch

from benchmark import data, harness
from benchmark.reference import lightgcn as ref
from benchmark.tests.conftest import CELLS, tiny_cell


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_every_cell_runs_correct_on_the_cpu(name, trace):
    cell = tiny_cell(name)
    r = harness.run_cell(cell, 2**31 + 101, 0.3, trace, "cpu")
    assert r["correct"], r["checks"]
    assert tuple(r["checks"]) == cell.loop.CHECKS
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    want = cell.per_layer if trace else cell.end_to_end
    assert set(r["metrics"]) <= {m["name"] for m in want}
    if not trace:
        assert set(r["metrics"]) == {m["name"] for m in want}
    else:
        assert r["device"]["window_s"] > 0 and "breakdown" in r


def test_norm_adjacency_matches_the_programs_weights():
    from gsrs_tpu_torch.data.adjacency import normalized_edge_weights

    x = data.interactions(50, 80, 600, 100, 1.1, seed=4)
    adj = ref.norm_adjacency(x.train_users, x.train_items, 50, 80, "cpu")
    w = normalized_edge_weights(x.train_users, x.train_items,
                                np.bincount(x.train_users, minlength=50),
                                np.bincount(x.train_items, minlength=80))
    dense = adj.to_dense()
    assert torch.allclose(dense[x.train_users, 50 + x.train_items],
                          torch.as_tensor(w, dtype=torch.float32))
    assert torch.equal(dense, dense.T)


def test_rank_gap_reads_zero_for_the_exact_ranking_and_more_for_a_swap():
    s = torch.tensor([[5.0, 4.0, 3.0, float("-inf")]])
    assert float(ref.rank_gap(s, torch.tensor([[0, 1]]))[0]) == 0.0
    assert float(ref.rank_gap(s, torch.tensor([[1, 0]]))[0]) == 1.0
    assert float(ref.rank_gap(s, torch.tensor([[0, 3]]))[0]) == float("inf")
