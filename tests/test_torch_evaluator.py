"""The port's metrics and Evaluator against the JAX package on JAX-CPU:
each metric on the same labels, and `Evaluator.run` on the same
parameters in the natural and the bit-plane branch, at several batch
sizes (metrics equal within 1e-6)."""

import functools

import numpy as np
import pytest
import torch

from gsrs_tpu_torch import config as tcfg
from gsrs_tpu_torch.convert import params_from_jax
from gsrs_tpu_torch.data import adjacency as tadj
from gsrs_tpu_torch.data import synthetic as tsyn
from gsrs_tpu_torch.models.registry import build_model
from gsrs_tpu_torch.ops import metrics as tmet
from gsrs_tpu_torch.ops.bitset import bitset_to_tensor, build_bitset
from gsrs_tpu_torch.ops.ell import ell_from_interactions
from gsrs_tpu_torch.train.evaluator import Evaluator

CPU = "cpu"
ATOL = 1e-6  # float32 sums of 0/1 labels and log2 discounts


@pytest.fixture
def jax():
    return pytest.importorskip("jax", reason="the JAX package is the reference")


def test_metrics_match_jax(jax):
    import jax.numpy as jnp

    from gsrs_tpu.ops import metrics as jmet

    rng = np.random.default_rng(0)
    labels = (rng.random((40, 20)) < 0.2).astype(np.float32)
    gt = rng.integers(0, 6, 40).astype(np.float32)
    weights = (rng.random(40) < 0.8).astype(np.float32)
    t = [torch.from_numpy(a) for a in (labels, gt, weights)]
    j = [jnp.asarray(a) for a in (labels, gt, weights)]
    for k in (1, 5, 20):
        for got, want in zip(tmet.recall_precision_at_k(t[0], t[1], k),
                             jmet.recall_precision_at_k(j[0], j[1], k)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        np.testing.assert_allclose(tmet.ndcg_at_k(t[0], t[1], k).numpy(),
                                   np.asarray(jmet.ndcg_at_k(j[0], j[1], k)), atol=ATOL)
    got, want = tmet.batch_metrics(*t, (5, 20)), jmet.batch_metrics(*j, (5, 20))
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_allclose(float(got[key]), float(want[key]), atol=1e-5)

    users = rng.integers(0, 30, 40)
    top = rng.integers(0, 50, (40, 20))
    bits = build_bitset(rng.integers(0, 30, 200), rng.integers(0, 50, 200), 30, 50)
    np.testing.assert_array_equal(
        tmet.topk_labels(torch.from_numpy(top), bitset_to_tensor(bits, CPU),
                         torch.from_numpy(users)).numpy(),
        np.asarray(jmet.topk_labels(jnp.asarray(top), jnp.asarray(bits), jnp.asarray(users))))


@pytest.mark.parametrize("case", ["ties", "random", "one_class"])
def test_auc_matches_jax(jax, case):
    import jax.numpy as jnp

    from gsrs_tpu.ops.metrics import auc as jauc

    rng = np.random.default_rng(1)
    scores = rng.standard_normal(300).astype(np.float32)
    if case == "ties":
        scores = np.round(scores, 1)
    pos = rng.random(300) < (0.0 if case == "one_class" else 0.1)
    got = tmet.auc(torch.from_numpy(scores), torch.from_numpy(pos))
    np.testing.assert_allclose(float(got), float(jauc(jnp.asarray(scores), jnp.asarray(pos))),
                               atol=ATOL)


def _pair(jax, test_batch, use_pallas_scoring):
    """(JAX Evaluator, port Evaluator) on the same clustered data and
    parameters; 150 items so the bit-plane branch pads to 4096."""
    from gsrs_tpu.config import EvalConfig as JEval, ModelConfig as JModel
    from gsrs_tpu.data.adjacency import build_graph as jgraph
    from gsrs_tpu.data.synthetic import clustered as jclustered
    from gsrs_tpu.models.registry import build_model as jbuild
    from gsrs_tpu.ops.ell import ell_from_interactions as jell
    from gsrs_tpu.train.evaluator import Evaluator as JEvaluator

    kw = dict(num_layers=2, embedding_dim=16)
    ekw = dict(test_batch=test_batch, topks=(5, 20), use_pallas_scoring=use_pallas_scoring)
    jd, td = jclustered(90, 150, seed=4), tsyn.clustered(90, 150, seed=4)
    jm = jbuild(JModel(**kw), jgraph(jd, 256), ell=jell(jd))
    params = jm.init_params(jax.random.key(2))
    tm = build_model(tcfg.ModelConfig(**kw), tadj.build_graph(td, 256),
                     ell=ell_from_interactions(td), device=CPU)
    tm.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in params.items()},
                                       tm.cfg, CPU))
    return (JEvaluator(jd, jm, JEval(**ekw)), params,
            Evaluator(td, tm, tcfg.EvalConfig(**ekw), device=CPU))


@pytest.mark.parametrize("use_pallas_scoring", ["off", "on"])
@pytest.mark.parametrize("test_batch", [16, 45, 2048])
def test_evaluator_run_matches_jax(jax, monkeypatch, use_pallas_scoring, test_batch):
    from gsrs_tpu.ops import pallas_kernels as pk

    # the JAX bit-plane kernel runs on the CPU only in interpret mode
    monkeypatch.setattr(pk, "masked_scores_bitplane_pallas", functools.partial(
        pk.masked_scores_bitplane_pallas, block_b=8, interpret=True))
    jev, params, tev = _pair(jax, test_batch, use_pallas_scoring)
    assert tev._bitplane == (use_pallas_scoring == "on")
    want, got = jev.run(params), tev.run()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, err_msg=k)
    assert got["recall@20"] > 0  # the propagated random model is not all misses


def test_evaluator_checks_what_it_is_given():
    data = tsyn.clustered(30, 40, seed=0)
    graph = tadj.build_graph(data, 256)
    model = build_model(tcfg.ModelConfig(num_layers=1, embedding_dim=4), graph, device=CPU)
    for method in ("approx", "threshold"):  # both run; parity in test_torch_topk.py
        got = Evaluator(data, model, tcfg.EvalConfig(topk_method=method), device=CPU).run()
        assert set(got) == {"recall@20", "precision@20", "ndcg@20"}
    with pytest.raises(ValueError, match="topk_method"):
        Evaluator(data, model, tcfg.EvalConfig(topk_method="fast"), device=CPU)
    with pytest.raises(ValueError, match="the model is on cpu"):
        Evaluator(data, model, tcfg.EvalConfig(), device="meta")
