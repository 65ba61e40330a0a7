"""A sequential training run whose timed path is broken underneath comes out
not correct: the harness's look for a card skipped, the run driven on the
CPU at its loop's tiny size, once for each fault, in every cell whose mix
runs ``loops/seq_train.py`` (picked from BENCHMARK.json): a step that
leaves the state unchanged, half of each batch's slots left out of the
loss, Eq. 7's output bias b^O dropped, the gradient's clipping skipped,
and the weight decay dropped."""

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import cells_of, tiny_cell

SEED = 2**31 + 212
CELLS = cells_of("seq_train")
# The published clip (global norm 5) does not act in the steps the check
# follows: the first gradient's global norm reads 0.14-0.16 at the tiny
# size, so skipping the clip there changes nothing any check could see.
# The clipping fault is planted where the clip acts, in program and
# reference alike.
ACTING_CLIP = 0.05
# At the tiny size a call is 4 steps, all inside BERT's warm-up, where the
# decay moves nothing a check can see; the decay fault is planted with the
# warm-up left out and the learning rate raised, in program and reference
# alike, so that 4 steps shrink each matrix's norm by 4e-5 of itself.
VISIBLE_DECAY = dict(warmup_steps=0, lr=1e-3)


def _run(name, **train):
    cell = tiny_cell(name)
    cell.cfg["train"].update(train)
    return harness.run_cell(cell, SEED, 0.3, False, "cpu")


@pytest.mark.parametrize("name", CELLS)
def test_a_step_that_leaves_the_state_unchanged(name, monkeypatch):
    from gsrs_tpu_torch.train import optim

    def unchanged(self, params, state):
        for p in params.values():
            p.grad = None
        return optim.AdamState(state.count + 1, state.optimizer)

    monkeypatch.setattr(optim.ScheduledAdam, "step", unchanged)
    r = _run(name)
    assert not r["correct"] and r["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", CELLS)
def test_half_the_slots_left_out_of_the_loss(name, monkeypatch):
    from gsrs_tpu_torch.models.bert4rec import BERT4Rec

    whole = BERT4Rec.cloze_softmax_loss

    def half(self, pos, draws):
        w = draws.weights.clone()
        w[w.shape[0] // 2:] = False
        return whole(self, pos, draws._replace(weights=w))

    monkeypatch.setattr(BERT4Rec, "cloze_softmax_loss", half)
    r = _run(name)
    assert not r["correct"] and r["checks"]["draws_invalid"]["value"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_the_output_bias_dropped(name, monkeypatch):
    from gsrs_tpu_torch.models.bert4rec import BERT4Rec

    monkeypatch.setattr(BERT4Rec, "output_logits",
                        lambda self, hs: self.head_query(hs) @ self.catalog().T)
    r = _run(name)
    assert not r["correct"] and r["checks"]["grad_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", CELLS)
def test_the_clip_skipped(name, monkeypatch):
    assert _run(name, clip_norm=ACTING_CLIP)["correct"]  # the clip acts, and both sides clip
    monkeypatch.setattr(torch.nn.utils, "clip_grad_norm_", lambda *args, **kw: None)
    r = _run(name, clip_norm=ACTING_CLIP)
    assert not r["correct"] and r["checks"]["grad_gap"]["value"] > 0.5


@pytest.mark.parametrize("name", CELLS)
def test_the_weight_decay_dropped(name, monkeypatch):
    from gsrs_tpu_torch.train import optim

    assert _run(name, **VISIBLE_DECAY)["correct"]  # the decay acts, and both sides decay
    init = optim.ScheduledAdam.init

    def undecayed(self, params):
        state = init(self, params)
        for group in state.optimizer.param_groups:
            group["weight_decay"] = 0.0
        return state

    monkeypatch.setattr(optim.ScheduledAdam, "init", undecayed)
    r = _run(name, **VISIBLE_DECAY)
    assert not r["correct"] and r["checks"]["norm_gap"]["value"] > r["checks"]["norm_gap"]["limit"]
