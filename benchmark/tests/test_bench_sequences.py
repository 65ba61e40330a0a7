"""The sequential cells' generator (`benchmark/sequences.py`) and the
BERT4Rec step's counts (`benchmark/counts/bert4rec.py`): exact action
counts, the length floor and cap, no item twice in a user's history, the
training sequences cut from the histories, the same sequences from one
seed and the same work from every seed; the counts on hand-worked
shapes."""

import numpy as np
import pytest

from benchmark import sequences
from benchmark.counts import bert4rec

SHAPE = dict(n_users=300, m_items=500, n_actions=300 * 70, max_len=50, min_length=20,
             max_length=400, zipf_s=1.1)


def test_the_published_counts_exactly_and_no_repeats():
    x = sequences.sequences(**SHAPE, seed=3)
    assert x.lengths.sum() == SHAPE["n_actions"]
    assert x.lengths.min() >= 20 and x.lengths.max() <= 400
    real = (x.train_seqs > 0).sum(axis=1)
    assert np.array_equal(real, np.minimum(x.lengths - 1, SHAPE["max_len"]))
    for row, target, n in zip(x.train_seqs, x.targets, real):
        items = row[SHAPE["max_len"] - n:]  # left-padded: the real items last
        assert (items > 0).all() and len(set(items.tolist()) | {int(target)}) == n + 1
    assert x.train_seqs.max() <= SHAPE["m_items"] and x.targets.min() >= 1


def test_one_seed_one_draw_and_every_seed_the_same_work():
    a = sequences.sequences(**SHAPE, seed=3)
    assert np.array_equal(a.train_seqs, sequences.sequences(**SHAPE, seed=3).train_seqs)
    b, c = sequences.relabeled(a, 11), sequences.relabeled(a, 12)
    assert not np.array_equal(b.train_seqs, c.train_seqs)
    for y in (b, c):
        assert np.array_equal(np.sort(y.lengths), np.sort(a.lengths))
        assert np.array_equal(np.sort((y.train_seqs > 0).sum(1)), np.sort((a.train_seqs > 0).sum(1)))


def test_the_step_counts_on_a_hand_worked_shape():
    cfg = {"data": {"m_items": 10},
           "model": {"max_len": 4, "embedding_dim": 2, "ffn_hidden": 8, "num_blocks": 1,
                     "max_predictions": 2},
           "train": {"batch_size": 3}}
    T, S = 12, 6  # tokens, slots
    block = 8 * T * 2 * 2 + 4 * T * 2 * 8 + 4 * T * 4 * 2
    head = 2 * S * 2 * 2 + 2 * S * 2 * 10
    assert bert4rec.step_flops(cfg) == 3 * (block + head)
    assert bert4rec.xent_bytes(cfg) == 2 * 4 * S * 10
    n = 12 * 2 + 4 * 2 + (4 * 4 + 2 * 2 * 8 + 8 + 2 + 4 * 2) + 4 + 2 + 10
    assert bert4rec.params(cfg) == n


def test_the_published_step():
    import json
    import os

    from benchmark.tests.conftest import ROOT

    with open(os.path.join(ROOT, "benchmark", "configs", "bert4rec-ml20m.json")) as f:
        cfg = json.load(f)
    # 3 (2 (24 T d² + 4 T N d) + 2 S d² + 2 S d m), T = 51,200, S = 10,240
    assert bert4rec.step_flops(cfg) == pytest.approx(151.34e9, rel=1e-4)
    assert bert4rec.xent_least_s(cfg) == pytest.approx(0.654e-3, rel=1e-3)
    assert bert4rec.train_step_least(cfg)[1] == "flops"
