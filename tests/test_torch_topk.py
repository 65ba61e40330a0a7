"""The port's top-k methods against the JAX package on JAX-CPU.

``threshold``: values and ids equal `gsrs_tpu.ops.topk.topk_threshold`'s
(ties included) on every case of tests/test_topk.py. ``approx``: the bin
count equals the width of JAX's ``approx_max_k(aggregate_to_topk=False)``
on a grid of (m, k, target); every returned (value, id) is a true pair,
sorted, and its recall of JAX's answer (exact on the CPU) meets the
target. Then the Evaluator with each method, natural and bit-plane,
against the JAX Evaluator: metrics within 1e-6 for exact and threshold,
within 1 − target for approx."""

import functools

import numpy as np
import pytest
import torch

from gsrs_tpu_torch import config as tcfg
from gsrs_tpu_torch.convert import params_from_jax
from gsrs_tpu_torch.data import adjacency as tadj
from gsrs_tpu_torch.data import synthetic as tsyn
from gsrs_tpu_torch.models.registry import build_model
from gsrs_tpu_torch.ops import topk as ttopk
from gsrs_tpu_torch.ops.ell import ell_from_interactions
from gsrs_tpu_torch.train.evaluator import Evaluator

CPU = "cpu"
METRIC_ATOL = 1e-6
NEG = -1e9


@pytest.fixture
def jax():
    return pytest.importorskip("jax", reason="the JAX package is the reference")


def _same_as_jax_threshold(scores, k):
    from gsrs_tpu.ops.topk import topk_threshold as jthreshold

    v, i = ttopk.topk_threshold(torch.from_numpy(scores), k)
    jv, ji = jthreshold(scores, k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    return v.numpy(), i.numpy()


# ------------------------------------------------------------------ threshold


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [(33, 3000), (8, 5000), (128, 2100)])
def test_threshold_matches_jax_random(jax, seed, shape):
    rng = np.random.default_rng(seed)
    _same_as_jax_threshold(rng.standard_normal(shape).astype(np.float32) * 3.0, 20)


def test_threshold_matches_jax_with_the_mask(jax):
    rng = np.random.default_rng(3)
    scores = rng.standard_normal((17, 4096)).astype(np.float32)
    scores[rng.random(scores.shape) < 0.3] = NEG
    _same_as_jax_threshold(scores, 10)


def test_threshold_matches_jax_under_heavy_ties(jax):
    rng = np.random.default_rng(4)
    scores = np.round(rng.standard_normal((9, 3000)) * 2).astype(np.float32)
    _same_as_jax_threshold(scores, 25)


def test_threshold_all_ties_falls_back_exact(jax):
    scores = np.zeros((5, 3000), np.float32)
    scores[:, :7] = 1.0  # top-7 distinct, the rest tie at 0: no threshold lands in [k, cap]
    v, i = _same_as_jax_threshold(scores, 20)
    np.testing.assert_array_equal(i[:, 7:], np.tile(np.arange(7, 20), (5, 1)))  # lowest first


def test_threshold_degenerate_rows(jax):
    rng = np.random.default_rng(5)
    scores = np.full((4, 3000), NEG, np.float32)
    scores[0, [10, 500, 2999]] = [3.0, 2.0, 1.0]
    scores[1] = rng.standard_normal(3000)
    v, i = _same_as_jax_threshold(scores, 5)
    np.testing.assert_array_equal(i[0, :3], [10, 500, 2999])
    assert (v[0, 3:] <= NEG / 2).all() and (v[2:] <= NEG / 2).all()


def test_threshold_small_catalog_and_topk_scores(jax):
    rng = np.random.default_rng(6)
    _same_as_jax_threshold(rng.standard_normal((7, 500)).astype(np.float32), 5)
    from gsrs_tpu.ops.topk import topk_scores as jtopk

    scores = rng.standard_normal((16, 4000)).astype(np.float32)
    v, i = ttopk.topk_scores(torch.from_numpy(scores), 20, method="threshold")
    jv, ji = jtopk(scores, 20, method="threshold")
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("dist", ["shifted", "scaled", "exponential", "pareto"])
def test_threshold_shifted_and_scaled(jax, dist):
    rng = np.random.default_rng(8)
    scores = {
        "shifted": lambda: rng.standard_normal((11, 3000)) * 1e-4 + 50.0,
        "scaled": lambda: rng.standard_normal((11, 3000)) * 1e4,
        "exponential": lambda: rng.exponential(2.0, (11, 3000)) - 100.0,
        "pareto": lambda: rng.pareto(3.0, (11, 3000)),
    }[dist]().astype(np.float32)
    _same_as_jax_threshold(scores, 20)


def test_stable_topk_orders_ties_lowest_first():
    scores = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    v, i = ttopk.stable_topk(scores, 4)
    assert i.tolist() == [[1, 2, 4, 3]] and v.tolist() == [[3.0, 3.0, 3.0, 2.0]]


# --------------------------------------------------------------------- approx

# the six points measured on JAX 0.9.0 (CPU), then a wider grid
_WIDTHS = [(40981, 20, 0.98, 1408), (40981, 20, 0.95, 768), (40981, 50, 0.98, 2688),
           (4096, 20, 0.98, 1024), (100000, 20, 0.98, 1664), (1000, 10, 0.9, 256)]


@pytest.mark.parametrize("m,k,target,width", _WIDTHS)
def test_approx_bins_match_the_recorded_widths(m, k, target, width):
    assert ttopk.approx_bins(m, k, target)[0] == width


def test_approx_bins_match_jax_on_a_grid(jax):
    import jax.numpy as jnp

    checked = 0
    for m in (100, 128, 129, 255, 256, 300, 1000, 1024, 3000, 4096, 5000, 40981, 65536,
              100000, 300000):
        for k in (1, 2, 5, 10, 20, 50, 100):
            for target in (0.5, 0.8, 0.9, 0.95, 0.98, 0.99, 0.999, 1.0):
                if k > m:
                    continue
                fn = functools.partial(jax.lax.approx_max_k, k=k, recall_target=target,
                                       aggregate_to_topk=False)
                out = jax.eval_shape(fn, jax.ShapeDtypeStruct((2, m), jnp.float32))
                assert ttopk.approx_bins(m, k, target)[0] == out[0].shape[1], (m, k, target)
                checked += 1
    assert checked > 700


@pytest.mark.parametrize("B,m,k,target", [
    (64, 40981, 20, 0.98), (64, 40981, 20, 0.95), (32, 40981, 50, 0.98),
    (64, 4096, 20, 0.98), (16, 100000, 20, 0.98), (64, 1000, 10, 0.9),
])
def test_approx_pairs_order_and_recall(jax, B, m, k, target):
    rng = np.random.default_rng(m + k)
    scores = rng.standard_normal((B, m)).astype(np.float32)
    v, i = ttopk.topk_approx(torch.from_numpy(scores), k, target)
    v, i = v.numpy(), i.numpy()
    assert v.shape == i.shape == (B, k)
    np.testing.assert_array_equal(np.take_along_axis(scores, i, axis=1), v)  # true pairs
    assert (np.diff(v, axis=1) <= 0).all()  # sorted
    assert all(len(set(row)) == k for row in i.tolist())
    _, ji = jax.lax.approx_max_k(scores, k, recall_target=target)  # exact on the CPU
    ji = np.asarray(ji)
    recall = np.mean([len(set(a) & set(b)) / k for a, b in zip(i.tolist(), ji.tolist())])
    assert recall >= target, recall


def test_approx_ranks_masked_items_above_the_padding():
    """A row of 5 real scores and 40,976 masked items: the 5 come first,
    then masked real items (−1e9), never a padding column (≥ m)."""
    m = 40981
    scores = np.full((3, m), NEG, np.float32)
    scores[:, [7, 900, 40000, 40980, 3]] = [5.0, 4.0, 3.0, 2.0, 1.0]
    scores[2] = NEG  # a fully masked row
    v, i = ttopk.topk_approx(torch.from_numpy(scores), 20, 0.98)
    i = i.numpy()
    assert (i < m).all()
    assert i[0, :5].tolist() == [7, 900, 40000, 40980, 3]
    assert (v.numpy()[0, 5:] == NEG).all() and (v.numpy()[2] == NEG).all()


def test_topk_scores_rejects_unknown_methods():
    with pytest.raises(ValueError, match="top-k method"):
        ttopk.topk_scores(torch.zeros(2, 10), 3, method="fast")
    with pytest.raises(ValueError, match="recall_target"):
        ttopk.approx_bins(4096, 20, 0.0)


# ------------------------------------------------------------------ evaluator


def _pair(jax, m_items, ekw):
    from gsrs_tpu.config import EvalConfig as JEval, ModelConfig as JModel
    from gsrs_tpu.data.adjacency import build_graph as jgraph
    from gsrs_tpu.data.synthetic import clustered as jclustered
    from gsrs_tpu.models.registry import build_model as jbuild
    from gsrs_tpu.ops.ell import ell_from_interactions as jell
    from gsrs_tpu.train.evaluator import Evaluator as JEvaluator

    kw = dict(num_layers=2, embedding_dim=16)
    jd, td = jclustered(120, m_items, seed=4), tsyn.clustered(120, m_items, seed=4)
    jm = jbuild(JModel(**kw), jgraph(jd, 256), ell=jell(jd))
    params = jm.init_params(jax.random.key(2))
    tm = build_model(tcfg.ModelConfig(**kw), tadj.build_graph(td, 256),
                     ell=ell_from_interactions(td), device=CPU)
    tm.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in params.items()},
                                       tm.cfg, CPU))
    return (JEvaluator(jd, jm, JEval(**ekw)).run(params),
            Evaluator(td, tm, tcfg.EvalConfig(**ekw), device=CPU))


@pytest.mark.parametrize("m_items,use_pallas_scoring", [(160, "off"), (4000, "on"),
                                                         (1500, "off")])
@pytest.mark.parametrize("method", ["exact", "threshold", "approx"])
def test_evaluator_methods_match_jax(jax, monkeypatch, m_items, use_pallas_scoring, method):
    """The 160-item clustered set; 1500 items take threshold past its
    direct-sort size in natural order; 4000 items fill the bit-plane
    layout's 4096 columns, where approx folds the permuted columns into
    1024 bins. (A catalog far below its padded width does not meet the
    target there: the permutation puts its few real columns in few bins,
    on the TPU as here.)"""
    from gsrs_tpu.ops import pallas_kernels as pk

    monkeypatch.setattr(pk, "masked_scores_bitplane_pallas", functools.partial(
        pk.masked_scores_bitplane_pallas, block_b=8, interpret=True))
    target = 0.98
    ekw = dict(test_batch=48, topks=(5, 20), use_pallas_scoring=use_pallas_scoring,
               topk_method=method, topk_recall_target=target)
    want, tev = _pair(jax, m_items, ekw)
    got = tev.run()
    assert set(got) == set(want)
    tol = METRIC_ATOL if method != "approx" else 1.0 - target
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=tol, err_msg=k)
    assert got["recall@20"] > 0
    if method != "exact":  # the ids against a stable sort of the plain scores
        top = tev.top_items().numpy()
        ref = torch.cat([ttopk.stable_topk(s, 20)[1] for s in _plain_scores(tev)])
        ref = ref[: tev.n_test_users].numpy()
        assert top.shape == ref.shape == (tev.n_test_users, 20)
        if method == "threshold":
            np.testing.assert_array_equal(top, ref)
        else:
            recall = np.mean([len(set(a) & set(b)) / 20
                              for a, b in zip(top.tolist(), ref.tolist())])
            assert recall >= target, recall


@torch.no_grad()
def _plain_scores(ev):
    """Every batch's masked scores in natural item order (plain version)."""
    from gsrs_tpu_torch.ops.scoring import masked_scores_reference

    all_users, items, _ = ev.model.final_embeddings()
    for users in ev._users:
        yield masked_scores_reference(all_users[users], items, ev.train_bitset[users])


def test_evaluator_rejects_unknown_methods():
    data = tsyn.clustered(30, 40, seed=0)
    model = build_model(tcfg.ModelConfig(num_layers=1, embedding_dim=4),
                        tadj.build_graph(data, 256), device=CPU)
    with pytest.raises(ValueError, match="topk_method"):
        Evaluator(data, model, tcfg.EvalConfig(topk_method="fast"), device=CPU)
