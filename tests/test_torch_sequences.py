"""The port's sequence data (`gsrs_tpu_torch.data.sequences`) against the
JAX package's: `sequences_from_interactions` and
`synthetic_markov_sequences` array for array, on seeded data; and the
JAX package's construction and truncation tests, ported. numpy only:
everything must be exactly equal."""

import numpy as np
import pytest

pytest.importorskip("jax", reason="the JAX package is the reference these tests compare with")

from gsrs_tpu.data import sequences as jseq
from gsrs_tpu.data.dataset import InteractionData as JData
from gsrs_tpu_torch.data import sequences as tseq
from gsrs_tpu_torch.data.dataset import InteractionData as TData


def _assert_same(a, b):
    for f in ("name", "n_users", "m_items", "max_len"):
        assert getattr(a, f) == getattr(b, f)
    for f in ("train_seqs", "eval_seqs", "eval_users", "eval_targets"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y)
    assert list(a.user_hist_sets) == list(b.user_hist_sets)
    for u in a.user_hist_sets:
        np.testing.assert_array_equal(a.user_hist_sets[u], b.user_hist_sets[u])


@pytest.mark.parametrize("max_len,min_len", [(4, 2), (12, 2), (6, 3)])
def test_sequences_from_interactions_match_jax(max_len, min_len):
    """Users in random file order, repeated items, users with one
    interaction (left out), histories longer than max_len (truncated)."""
    rng = np.random.default_rng(max_len)
    n, m = 30, 40
    u = rng.integers(0, n, 400)
    i = rng.integers(0, m, 400)
    args = ("s", n, m, u.astype(np.int64), i.astype(np.int64), {})
    _assert_same(jseq.sequences_from_interactions(JData(*args), max_len, min_len),
                 tseq.sequences_from_interactions(TData(*args), max_len, min_len))


@pytest.mark.parametrize("seed,p_stay", [(0, 0.85), (3, 0.95)])
def test_synthetic_markov_sequences_match_jax(seed, p_stay):
    kw = dict(n_users=50, m_items=60, n_clusters=5, max_len=10, seed=seed, p_stay=p_stay)
    _assert_same(jseq.synthetic_markov_sequences(**kw), tseq.synthetic_markov_sequences(**kw))


def test_sequence_construction_leave_last_out():
    u = np.array([0, 0, 0, 1, 1, 2])
    i = np.array([5, 3, 7, 2, 4, 9])
    seq = tseq.sequences_from_interactions(TData("t", 3, 10, u, i, {}), max_len=4, min_len=2)
    assert len(seq.eval_users) == 2  # user 2 has one interaction
    row0 = seq.train_seqs[list(seq.eval_users).index(0)]
    np.testing.assert_array_equal(row0, [0, 0, 6, 4])  # [5, 3] shifted +1
    assert seq.eval_targets[list(seq.eval_users).index(0)] == 8
    assert 8 not in seq.user_hist_sets[0]  # the held-out item is not history


def test_truncation_keeps_most_recent():
    items = np.concatenate([np.arange(10, dtype=np.int64), [11]])
    seq = tseq.sequences_from_interactions(
        TData("t", 1, 12, np.zeros(11, np.int64), items, {}), max_len=4)
    np.testing.assert_array_equal(seq.train_seqs[0], [7, 8, 9, 10])  # shifted ids of 6..9
