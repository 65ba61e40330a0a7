"""An HSTU training run whose timed path is broken underneath comes out not
correct: the harness's look for a card skipped, the run driven on the CPU
at its loop's tiny size, once for each fault, in every cell whose mix runs
``loops/hstu_train.py`` (picked from BENCHMARK.json): the time term of the
relative bias dropped, PAD keys left in the attention mask, a negative
equal to its target left in the softmax, and half of each batch's slots
left out of the loss. Marked ``gpu`` (a replay needs a card): the times of
a replayed step left stale in the captured graph's inputs."""

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import cells_of, tiny_cell

SEED = 2**31 + 262
CELLS = cells_of("hstu_train")


def _run(name, device="cpu"):
    return harness.run_cell(tiny_cell(name), SEED, 0.3, False, device)


def _fails(r, *checks):
    assert not r["correct"]
    assert any(r["checks"][k]["value"] > r["checks"][k]["limit"] for k in checks), r["checks"]
    assert r["checks"]["draws_invalid"]["value"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_the_time_term_dropped(name, monkeypatch):
    from gsrs_tpu_torch.models.hstu import HSTU

    whole = HSTU.relative_bias

    def positions_only(self, b, buckets):
        return whole(self, b, torch.zeros_like(buckets)) - getattr(self, f"b{b}_ts_w")[0]

    monkeypatch.setattr(HSTU, "relative_bias", positions_only)
    _fails(_run(name), "grad_gap", "change_gap", "replay_change_gap")


@pytest.mark.parametrize("name", CELLS)
def test_pad_keys_left_in_the_mask(name, monkeypatch):
    from gsrs_tpu_torch.models.hstu import HSTU

    def causal_only(self, seqs):
        N = seqs.shape[1]
        causal = torch.tril(torch.ones(N, N, dtype=torch.bool, device=seqs.device))
        return causal[None].expand(seqs.shape[0], N, N)

    monkeypatch.setattr(HSTU, "attention_mask", causal_only)
    _fails(_run(name), "loss_gap", "grad_gap", "change_gap")


@pytest.mark.parametrize("name", CELLS)
def test_a_negative_equal_to_its_target_left_in(name, monkeypatch):
    from gsrs_tpu_torch.models.hstu import HSTU

    monkeypatch.setattr(HSTU, "exclude_collisions", lambda self, logits, pos, neg: logits)
    _fails(_run(name), "loss_gap", "grad_gap", "change_gap")


@pytest.mark.parametrize("name", CELLS)
def test_half_the_slots_left_out_of_the_loss(name, monkeypatch):
    from gsrs_tpu_torch.models.hstu import HSTU

    whole = HSTU.loss_weight

    def half(self, pos, draws=None, seqs=None):
        w = whole(self, pos, draws, seqs).clone()
        w[w.shape[0] // 2:] = False
        return w

    monkeypatch.setattr(HSTU, "loss_weight", half)
    _fails(_run(name), "loss_gap", "grad_gap", "change_gap")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_stale_times_in_a_replayed_step(name, monkeypatch, cuda_card):
    from gsrs_tpu_torch.train import seq_trainer

    assert _run(name, cuda_card)["correct"]  # the replays are right with their own times
    whole = seq_trainer._StepGraph.replay

    def stale(self, seqs, draws, times=None):
        return whole(self, seqs, draws, self.times)

    monkeypatch.setattr(seq_trainer._StepGraph, "replay", stale)
    r = _run(name, cuda_card)
    _fails(r, "replay_loss_gap", "replay_change_gap")
    for k in ("loss_gap", "grad_gap", "change_gap"):  # the eager steps are untouched
        assert r["checks"][k]["value"] <= r["checks"][k]["limit"], k
