"""The port's serving path on the CPU against the JAX package's: the same
recommendations from the same weights on both scoring layouts and on
int8 artifacts, artifacts that load in both directions, and the same
``query`` CLI output."""

import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="the JAX package is the reference these tests compare with")

import jax

from gsrs_tpu import serve as jserve
from gsrs_tpu.config import ModelConfig as JaxModelConfig
from gsrs_tpu.data.adjacency import build_graph as jax_build_graph
from gsrs_tpu.models.registry import build_model as jax_build_model
from gsrs_tpu.ops import pallas_kernels as pk
from gsrs_tpu.ops.ell import ell_from_interactions as jax_ell
from gsrs_tpu_torch import serve as tserve
from gsrs_tpu_torch.config import ModelConfig
from gsrs_tpu_torch.convert import params_from_jax
from gsrs_tpu_torch.data.adjacency import build_graph
from gsrs_tpu_torch.data.dataset import InteractionData
from gsrs_tpu_torch.models.registry import build_model
from gsrs_tpu_torch.ops.bitset import build_bitset
from gsrs_tpu_torch.ops.ell import ell_from_interactions

CPU = "cpu"
SCORE_ATOL = 1e-5


def _port_data(data):
    return InteractionData(
        name=data.name, n_users=data.n_users, m_items=data.m_items,
        train_users=data.train_users, train_items=data.train_items,
        test_dict=data.test_dict,
    )


@pytest.fixture
def retrievers(tiny_data):
    """(JAX Retriever, port Retriever) from the same 2-layer weights."""
    cfg = dict(num_layers=2, embedding_dim=8)
    jm = jax_build_model(JaxModelConfig(**cfg), jax_build_graph(tiny_data, 256),
                         ell=jax_ell(tiny_data))
    params = jm.init_params(jax.random.key(0))
    data = _port_data(tiny_data)
    tm = build_model(ModelConfig(**cfg), build_graph(data, 256), ell=ell_from_interactions(data),
                     device=CPU)
    tm.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in params.items()},
                                       tm.cfg, CPU))
    return (jserve.retriever_from_model(jm, params, tiny_data, batch_size=16),
            tserve.retriever_from_model(tm, data, batch_size=16, device=CPU))


def _same(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_allclose(a[1], b[1], atol=SCORE_ATOL)


def _interpret_bitplane(monkeypatch):
    """The JAX bit-plane kernel runs on the CPU only in interpret mode."""
    monkeypatch.setattr(pk, "masked_scores_bitplane_pallas", functools.partial(
        pk.masked_scores_bitplane_pallas, block_b=8, interpret=True))


def test_recommend_matches_jax(retrievers, tiny_data):
    jr, tr = retrievers
    users = list(range(0, tiny_data.n_users, 3))
    got = tr.recommend(users, k=10)
    _same(got, jr.recommend(users, k=10))
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32
    net = np.zeros((tiny_data.n_users, tiny_data.m_items), bool)
    net[tiny_data.train_users, tiny_data.train_items] = True
    for u, row in zip(users, got[0]):
        assert not net[u, row].any()


def test_bitplane_recommend_matches_jax(retrievers, tiny_data, monkeypatch):
    _interpret_bitplane(monkeypatch)
    jr, tr = retrievers
    kw = dict(batch_size=16, use_pallas_scoring="on")
    jb = jserve.Retriever(np.asarray(jr.user_emb), np.asarray(jr.item_emb),
                          np.asarray(jr.seen_bitset), **kw)
    tb = tserve.Retriever(tr.user_emb, tr.item_emb, tr.seen_bitset, device=CPU, **kw)
    assert tb._serve_tables[1].shape[0] % 4096 == 0
    users = list(range(tiny_data.n_users))
    _same(tb.recommend(users, k=10), jb.recommend(users, k=10))
    _same(tb.recommend(users, k=10), tr.recommend(users, k=10))
    # the public fields stay canonical: natural order, real sizes
    assert torch.equal(tb.item_emb, tr.item_emb)
    assert torch.equal(tb.seen_bitset, tr.seen_bitset)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("quantize", [None, "int8"])
def test_artifacts_load_in_both_packages(retrievers, tiny_data, tmp_path, direction, quantize):
    jr, tr = retrievers
    path = str(tmp_path / "emb.npz")
    if direction == "jax_to_port":
        jserve.export_embeddings(jr, path, quantize=quantize)
    else:
        tserve.export_embeddings(tr, path, quantize=quantize)
    with np.load(path) as z:
        assert z["seen_bitset"].dtype == np.uint32
    users = list(range(0, tiny_data.n_users, 2))
    tl = tserve.load_retriever(path, batch_size=16, device=CPU)
    _same(tl.recommend(users, k=8), jserve.load_retriever(path, batch_size=16).recommend(users, k=8))
    if quantize is None:
        _same(tl.recommend(users, k=8), tr.recommend(users, k=8))
    else:
        assert tl.user_emb.dtype == torch.int8


def test_exports_are_identical_across_packages(retrievers, tmp_path):
    jr, tr = retrievers
    for quantize in (None, "int8"):
        jserve.export_embeddings(jr, str(tmp_path / "j.npz"), quantize=quantize)
        tserve.export_embeddings(tr, str(tmp_path / "t.npz"), quantize=quantize)
        with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
            assert sorted(j.files) == sorted(t.files)
            for name in j.files:
                assert j[name].dtype == t[name].dtype, name
                np.testing.assert_allclose(t[name], j[name], atol=1e-6, err_msg=name)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_phantom_slots_are_minus_one(tmp_path, quantize):
    rng = np.random.default_rng(0)
    n, m, d = 4, 8, 4
    ue = rng.standard_normal((n, d)).astype(np.float32)
    ie = rng.standard_normal((m, d)).astype(np.float32)
    seen = build_bitset(np.zeros(6, np.int64), np.arange(6), n, m)  # user 0 saw 0..5
    path = str(tmp_path / "emb.npz")
    tserve.export_embeddings(tserve.Retriever(ue, ie, seen, device=CPU), path, quantize=quantize)
    r = tserve.load_retriever(path, batch_size=4, device=CPU)
    items, scores = r.recommend([0, 1], k=5)
    assert set(items[0][:2]) == {6, 7}
    np.testing.assert_array_equal(items[0][2:], [-1, -1, -1])
    np.testing.assert_array_equal(scores[0][2:], np.float32(-1e9))
    assert (items[1] >= 0).all()
    _same((items, scores), jserve.load_retriever(path, batch_size=4).recommend([0, 1], k=5))


def test_out_of_range_ids_raise(retrievers, tiny_data):
    _, tr = retrievers
    with pytest.raises(ValueError, match="out of range"):
        tr.recommend([0, tiny_data.n_users], k=5)
    with pytest.raises(ValueError, match="out of range"):
        tr.recommend([-1], k=5)


@pytest.mark.parametrize("mode", ["auto", "on"])
def test_query_cli_prints_what_jax_prints(retrievers, tmp_path, capsys, monkeypatch, mode):
    _interpret_bitplane(monkeypatch)
    jr, _ = retrievers
    art = str(tmp_path / "emb.npz")
    jserve.export_embeddings(jr, art)
    args = ["query", "--artifact", art, "--users", "0", "3", "7", "--k", "5",
            "--use_pallas_scoring", mode]
    jserve.main(args)
    jax_out = capsys.readouterr().out
    tserve.main(args + ["--device", CPU])
    port_out = capsys.readouterr().out
    assert port_out == jax_out
    assert port_out.count("user ") == 3


def test_entry_points_default_to_cuda(tmp_path, retrievers):
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only behaviour of the entry points")
    _, tr = retrievers
    path = str(tmp_path / "emb.npz")
    tserve.export_embeddings(tr, path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.load_retriever(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.Retriever(tr.user_emb, tr.item_emb, tr.seen_bitset)
