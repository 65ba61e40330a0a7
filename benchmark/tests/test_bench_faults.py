"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped, the rest of the run driven on the CPU
at a tiny size, once for each fault a cell can have; each fault runs in
every cell of the loop it breaks, picked from BENCHMARK.json by its
mix's ``loop``. (No cell spans chips, so none can leave out the exchange
between them.) And the control, the reference in the precision below the
configuration's, fails at least one of each cell's limits."""

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import CELLS, cells_of, tiny_cell

SEED = 2**31 + 202


def _run(name):
    return harness.run_cell(tiny_cell(name), SEED, 0.3, False, "cpu")


@pytest.mark.parametrize("name", cells_of("train"))
def test_a_step_that_leaves_the_state_unchanged(name, monkeypatch):
    from gsrs_tpu_torch.train import fused_adam, optim

    def unchanged_adam(self, params, state):
        for p in params.values():
            p.grad = None
        return optim.AdamState(state.count + 1, state.optimizer)

    def unchanged_fused(self, params, state):
        for p in params.values():
            p.grad = None
        return fused_adam.FusedAdamState(state.count + 1, state.mu, state.nu, state.plan)

    monkeypatch.setattr(optim.ScheduledAdam, "step", unchanged_adam)
    monkeypatch.setattr(fused_adam.FusedAdam, "step", unchanged_fused)
    r = _run(name)
    assert not r["correct"] and r["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", cells_of("train"))
def test_half_the_batch_left_out(name, monkeypatch):
    from gsrs_tpu_torch.models.lightgcn import LightGCN

    whole = LightGCN._pairwise_bpr

    def half(self, all_users, items, gate, users, pos, neg):
        h = users.shape[0] // 2
        return whole(self, all_users, items, gate, users[:h], pos[:h], neg[:h])

    monkeypatch.setattr(LightGCN, "_pairwise_bpr", half)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", cells_of("eval"))
def test_an_eval_answer_altered(name, monkeypatch):
    from gsrs_tpu_torch.train.evaluator import Evaluator

    right = Evaluator._top_items

    def altered(self, u_emb, items, rows):
        top, valid = right(self, u_emb, items, rows)
        top = top.clone()
        top[0, 0] = (top[0, 0] + 1) % items.shape[0]
        return top, valid

    monkeypatch.setattr(Evaluator, "_top_items", altered)
    r = _run(name)
    assert not r["correct"] and r["checks"]["rank_gap"]["value"] > 0


@pytest.mark.parametrize("name", cells_of("serve"))
def test_a_served_answer_altered(name, monkeypatch):
    from gsrs_tpu_torch.serve import Retriever

    right = Retriever._score_topk

    def altered(self, ids, k):
        vals, top = right(self, ids, k)
        top = top.clone()
        top[:, 0] = (top[:, 0] + 1) % self.m_items
        return vals, top

    monkeypatch.setattr(Retriever, "_score_topk", altered)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_a_limit(name):
    cell = tiny_cell(name)
    limits = harness.load_cell(name).limits  # the cell's own, not the tiny size's
    for seed in (SEED, SEED + 1, SEED + 2):
        inputs = cell.loop.make_inputs(cell.cfg, cell.traffic, seed, "cpu")
        readings = cell.loop.control(cell.cfg, cell.traffic, inputs, seed, "cpu")["control"]
        assert any(v > limits[k] for k, v in readings.items()), (seed, readings, limits)
