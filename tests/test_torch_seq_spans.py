"""The sequential trainer's spans (`gsrs_tpu_torch.train.seq_trainer`), as
the benchmark's readers take them: on the CPU, one ``train.step`` a step
inside its ``train.call``, each holding its draws, forward, backward and
optimizer, the published BERT4Rec's ``seq.encode`` and ``seq.head`` inside
the forward and ``train.clip`` inside the optimizer, ``train.call`` and
``seq.head`` carrying their shapes, and one ``sync.train.loss`` a call.
Marked ``gpu`` (run on the card): every host–device sync of a call stands
in a ``sync.*`` span (the count of `torch.cuda.set_sync_debug_mode`'s
warnings)."""

import warnings
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gsrs_tpu_torch.data.sequences import SequenceData
from gsrs_tpu_torch.models.registry import build_seq_model
from gsrs_tpu_torch.train.seq_trainer import SeqTrainer
from gsrs_tpu_torch.utils.timer import spans

M, L, D, P, B = 50, 10, 16, 3, 8


def _data(rows=40):
    g = np.random.default_rng(0)
    seqs = g.integers(1, M + 1, (rows, L))
    seqs[::3, :4] = 0  # some left padding
    hist = {u: row[row > 0] for u, row in enumerate(seqs)}
    return SequenceData("tiny", rows, M, L, seqs, seqs, np.arange(rows),
                        g.integers(1, M + 1, rows), hist)


def _trainer(kind, device, **model_kw):
    model = build_seq_model(kind, M, max_len=L, dim=D, hidden=4 * D, heads=2, device=device,
                            **model_kw)
    published = model_kw.get("published", 0) > 0
    opt_kw = dict(warmup_steps=2, decay_steps=100, weight_decay=0.01, clip_norm=5.0,
                  adam_eps=1e-6) if published else {}
    return SeqTrainer(model, _data(), batch_size=B, lr=1e-3, seed=3, device=device, **opt_kw)


def _published(device):
    return _trainer("bert4rec", device, published=P, mask_prob=0.2, last_only_prob=0.1)


def _children(tape, parent):
    return sorted((s for s in tape if s.parent == parent.id), key=lambda s: s.start_ns)


def test_a_published_call_records_its_steps_and_shapes():
    tr = _published("cpu")
    tr.steps_per_call = 3
    state = tr.init_state()
    with profile(activities=[ProfilerActivity.CPU]):
        tr.train_epoch(state)
    tape = spans()
    count = Counter(s.name for s in tape)
    assert count["train.call"] == 1 and count["sync.train.loss"] == 1
    for name in ("train.step", "train.sample", "train.forward", "train.backward",
                 "train.optimizer", "train.clip", "seq.encode", "seq.head"):
        assert count[name] == 3, name
    (call,) = [s for s in tape if s.name == "train.call"]
    assert call.attrs["shape"] == (3, B, L)
    for step in (s for s in tape if s.name == "train.step"):
        assert step.parent == call.id and step.unit == call.id
        assert [c.name for c in _children(tape, step)] == [
            "train.sample", "train.forward", "train.backward", "train.optimizer"]
    by_id = {s.id: s for s in tape}
    for s in tape:
        if s.name in ("seq.encode", "seq.head"):
            assert by_id[s.parent].name == "train.forward"
        if s.name == "train.clip":
            assert by_id[s.parent].name == "train.optimizer"
    heads = [s.attrs["shape"] for s in tape if s.name == "seq.head"]
    assert heads == [(B * P, M, D)] * 3
    assert [s.name for s in tape if s.name.startswith("sync.")] == ["sync.train.loss"]


@pytest.mark.parametrize("kind", ["sasrec", "gru4rec", "bert4rec"])
def test_a_default_epoch_records_a_step_a_step(kind):
    tr = _trainer(kind, "cpu")
    state = tr.init_state()
    with profile(activities=[ProfilerActivity.CPU]):
        tr.train_epoch(state)
    count = Counter(s.name for s in spans())
    assert count["train.step"] == tr.steps_per_epoch == 5
    assert count["train.call"] == count["sync.train.loss"] == 1
    assert count["train.clip"] == count["seq.head"] == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the syncs are the card's")
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_every_sync_of_a_call_on_the_card_stands_in_a_sync_span(cuda):
    tr = _published(cuda)
    tr.steps_per_call = 4
    state = tr.init_state()
    state, _ = tr.train_epoch(state)  # set-up's first reads fall in the first call
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                tr.train_epoch(state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    warned = sum("synchroniz" in str(w.message) for w in caught)
    syncs = [s.name for s in spans() if s.name.startswith("sync.")]
    assert warned == len(syncs) == 1, (warned, syncs, [str(w.message) for w in caught][:5])
