"""The port's session serving (`gsrs_tpu_torch.serve_seq`): the JAX
package's serving tests, ported (shapes and exclusion, batch padding,
validation, left padding, the artifact round trip, a trained model's
recommendations, the export/query CLI), and the artifact read in both
directions: JAX's `load_seq_retriever` serves the port's artifact and the
port serves JAX's, with the same top-k. Scores within 1e-5 (fp32 sums in
another order); ids compared only where the scores are not tied
(`torch.topk` does not order ties as ``lax.top_k`` does)."""

import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="the JAX package is the reference these tests compare with")

import jax

from gsrs_tpu.models.registry import build_seq_model as jbuild
from gsrs_tpu.serve_seq import SeqRetriever as JSeqRetriever
from gsrs_tpu.serve_seq import export_seq_model as jexport
from gsrs_tpu.serve_seq import load_seq_retriever as jload
from gsrs_tpu_torch.convert import seq_params_from_jax
from gsrs_tpu_torch.data.sequences import synthetic_markov_sequences
from gsrs_tpu_torch.models.registry import SEQ_MODELS, build_seq_model
from gsrs_tpu_torch.serve_seq import (
    SeqRetriever, export_seq_model, load_seq_retriever, main,
)
from gsrs_tpu_torch.train.seq_trainer import SeqTrainer

M_ITEMS, MAX_LEN = 60, 12
HYPER = dict(max_len=MAX_LEN, dim=8, hidden=8, blocks=1, heads=1)
SCORE_TOL = 1e-5
SESSIONS = [[0, 5, 9], [3], list(range(20)), [59, 1, 1, 58]]


def _retriever(kind="sasrec", seed=0, **kw):
    model = build_seq_model(kind, m_items=M_ITEMS, dropout=0.0, device="cpu",
                            generator=torch.Generator().manual_seed(seed), **HYPER)
    return SeqRetriever(model, device="cpu", **kw)


def assert_same_topk(items_a, scores_a, items_b, scores_b):
    """Scores equal within SCORE_TOL everywhere; ids equal wherever a
    score is apart from its neighbours by more than that."""
    np.testing.assert_allclose(scores_a, scores_b, rtol=SCORE_TOL, atol=SCORE_TOL)
    gaps = np.abs(np.diff(scores_b, axis=1))
    untied = np.ones_like(scores_b, dtype=bool)
    untied[:, 1:] &= gaps > SCORE_TOL
    untied[:, :-1] &= gaps > SCORE_TOL
    np.testing.assert_array_equal(items_a[untied], items_b[untied])


@pytest.mark.parametrize("kind", SEQ_MODELS)
def test_recommend_shapes_and_exclusion(kind):
    r = _retriever(kind)
    sessions = [[0, 5, 9], [3], list(range(20))]  # one longer than max_len
    items, scores = r.recommend(sessions, k=10)
    assert items.shape == (3, 10) and scores.shape == (3, 10)
    assert items.dtype == np.int32 and scores.dtype == np.float32
    for sess, row in zip(sessions, items):
        assert not set(row.tolist()) & set(sess)
        assert (row >= 0).all() and (row < M_ITEMS).all()
    assert (np.diff(scores, axis=1) <= 1e-6).all()


def test_batch_padding_consistency():
    sessions = [[i, (i * 7) % M_ITEMS] for i in range(5)]
    items_a, scores_a = _retriever(batch_size=2).recommend(sessions, k=5)
    items_b, scores_b = _retriever(batch_size=64).recommend(sessions, k=5)
    np.testing.assert_array_equal(items_a, items_b)
    np.testing.assert_allclose(scores_a, scores_b, rtol=1e-5)


def test_session_validation_on_the_host():
    r = _retriever()
    with pytest.raises(ValueError, match="out of range"):
        r.recommend([[0, M_ITEMS]], k=5)
    with pytest.raises(ValueError, match="out of range"):
        r.recommend([[-1, 3]], k=5)
    with pytest.raises(ValueError, match="empty"):
        r.recommend([[]], k=5)


def test_left_padding_matches_sequences_layout():
    r = _retriever()
    seqs, seen = r._encode_sessions([[4, 2, 7]])
    expected = np.zeros(MAX_LEN, np.int32)
    expected[-3:] = [5, 3, 8]
    np.testing.assert_array_equal(seqs[0], expected)
    for i in (4, 2, 7):
        assert seen[0, i // 32] >> (i % 32) & 1


def test_encode_sessions_matches_jax():
    jm = jbuild("gru4rec", M_ITEMS, dropout=0.0, **HYPER)
    jr = JSeqRetriever(jm, jm.init_params(jax.random.key(0)))
    tr = _retriever("gru4rec")
    for got, want in zip(tr._encode_sessions(SESSIONS), jr._encode_sessions(SESSIONS)):
        np.testing.assert_array_equal(got, want)


def test_artifact_roundtrip(tmp_path):
    r = _retriever()
    path = os.path.join(tmp_path, "seq.npz")
    export_seq_model(r.params, "sasrec", M_ITEMS, path, **HYPER)
    r2 = load_seq_retriever(path, batch_size=64, device="cpu")
    sessions = [[1, 2, 3], [10, 20]]
    items_a, scores_a = r.recommend(sessions, k=8)
    items_b, scores_b = r2.recommend(sessions, k=8)
    np.testing.assert_array_equal(items_a, items_b)
    np.testing.assert_allclose(scores_a, scores_b, rtol=1e-5)


@pytest.mark.parametrize("kind", SEQ_MODELS)
def test_artifacts_serve_in_both_packages(kind, tmp_path):
    """JAX's artifact served by the port, and the port's by JAX: the same
    top-k as JAX's retriever on JAX's parameters; the meta and the arrays
    of the two artifacts equal."""
    jm = jbuild(kind, M_ITEMS, dropout=0.0, **HYPER)
    jparams = jm.init_params(jax.random.key(4))
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jexport(jparams, kind, M_ITEMS, jpath, **HYPER)
    want_items, want_scores = JSeqRetriever(jm, jparams).recommend(SESSIONS, k=10)

    from_jax = load_seq_retriever(jpath, device="cpu")
    assert_same_topk(*from_jax.recommend(SESSIONS, k=10), want_items, want_scores)

    tm = build_seq_model(kind, M_ITEMS, dropout=0.0, device="cpu", **HYPER)
    tm.load_state_dict(seq_params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                                           kind, "cpu"))
    export_seq_model(tm.params(), kind, M_ITEMS, tpath, **HYPER)
    by_jax = jload(tpath)
    assert_same_topk(*by_jax.recommend(SESSIONS, k=10), want_items, want_scores)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        assert json.loads(str(a["__meta__"])) == json.loads(str(b["__meta__"]))
        for f in a.files:
            if f != "__meta__":
                np.testing.assert_array_equal(a[f], b[f])


def test_trained_model_predicts_cluster():
    """Trained briefly on cluster-Markov data, an in-cluster session's
    recommendations fall in that cluster far above chance (0.2)."""
    data = synthetic_markov_sequences(n_users=300, m_items=M_ITEMS, n_clusters=5,
                                      max_len=MAX_LEN, seed=3, p_stay=0.95)
    model = build_seq_model("sasrec", m_items=M_ITEMS, max_len=MAX_LEN, dim=16, hidden=16,
                            blocks=1, heads=1, dropout=0.0, device="cpu")
    trainer = SeqTrainer(model, data, batch_size=64, lr=5e-3, seed=0, device="cpu")
    state = trainer.init_state()
    for _ in range(30):
        state, _ = trainer.train_epoch(state)
    r = SeqRetriever(model, batch_size=8, device="cpu")
    cluster_of = (np.arange(M_ITEMS) * 5) // M_ITEMS
    cluster0 = [int(i) for i in np.flatnonzero(cluster_of == 0)[:6]]
    items, _ = r.recommend([cluster0], k=5)
    frac = np.mean(cluster_of[items[0]] == 0)
    assert frac >= 0.6, f"in-cluster fraction {frac} (chance ≈ 0.2)"


def test_cli_export_query(tmp_path, capsys):
    """fit with a checkpoint directory, then ``export`` (from
    model_meta.json) and ``query`` through the CLI on the CPU; the
    queried top-k equals a live retriever's."""
    data = synthetic_markov_sequences(n_users=64, m_items=M_ITEMS, max_len=MAX_LEN, seed=1)
    model = build_seq_model("gru4rec", m_items=M_ITEMS, max_len=MAX_LEN, dim=8, hidden=8,
                            blocks=1, dropout=0.0, device="cpu")
    ckdir = os.path.join(tmp_path, "ck")
    SeqTrainer(model, data, batch_size=32, seed=0, device="cpu").fit(
        epochs=1, checkpoint_dir=ckdir, eval_every=10, verbose=False)
    art = os.path.join(tmp_path, "seq.npz")
    main(["export", "--checkpoint_dir", ckdir, "--out", art, "--device", "cpu"])
    main(["query", "--artifact", art, "--session", "1", "2", "3", "--k", "5",
          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "exported" in out and "session [1, 2, 3]:" in out
    printed = [int(p.split(":")[0]) for p in out.strip().splitlines()[-1].split(": ", 1)[1].split()]
    live, _ = SeqRetriever(model, batch_size=1, device="cpu").recommend([[1, 2, 3]], k=5)
    assert printed == live[0].tolist()


def test_cli_export_from_flags_without_meta(tmp_path, capsys):
    """A checkpoint directory without model_meta.json exports from the
    flags (the JAX CLI's fallback)."""
    data = synthetic_markov_sequences(n_users=40, m_items=M_ITEMS, max_len=MAX_LEN, seed=2)
    model = build_seq_model("sasrec", m_items=M_ITEMS, dropout=0.0, device="cpu", **HYPER)
    ckdir = os.path.join(tmp_path, "ck")
    SeqTrainer(model, data, batch_size=32, seed=0, device="cpu").fit(
        epochs=1, checkpoint_dir=ckdir, eval_every=10, verbose=False)
    os.remove(os.path.join(ckdir, "model_meta.json"))
    art = os.path.join(tmp_path, "seq.npz")
    main(["export", "--checkpoint_dir", ckdir, "--out", art, "--model", "sasrec",
          "--m_items", str(M_ITEMS), "--max_len", str(MAX_LEN), "--dim", "8", "--hidden", "8",
          "--blocks", "1", "--device", "cpu"])
    r = load_seq_retriever(art, device="cpu")
    for k, v in model.params().items():
        assert torch.equal(r.params[k], v.detach()), k
