"""The port's planted-order sequential benchmark
(`gsrs_tpu_torch.tools.bench_seq_markov`) against the JAX package's
(``tools/bench_seq_markov.py``) on the CPU at a tiny size.

- `popularity_baseline` (the order-blind ranker, pure numpy) equals the
  JAX tool's on the same `synthetic_markov_sequences` data, which the two
  packages build equal.
- At ``--epochs 1 --n_users 200 --m_items 50`` both print the chance and
  popularity rows equal, then SASRec, GRU4Rec and BERT4Rec rows with the
  JAX tool's keys (the port's ``launches`` aside). The models' metrics
  differ (``jax.random`` against a torch generator), so they are held to
  their range.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest

from gsrs_tpu_torch.data.sequences import synthetic_markov_sequences
from gsrs_tpu_torch.tools import bench_seq_markov

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
TINY = ["--epochs", "1", "--n_users", "200", "--m_items", "50", "--dim", "16"]


@pytest.fixture
def jax_tool():
    pytest.importorskip("jax", reason="the JAX package is the reference")
    spec = importlib.util.spec_from_file_location(
        "jax_tool_bench_seq_markov", os.path.join(ROOT, "tools", "bench_seq_markov.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json_rows(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("shape", [(300, 80, 4, 12), (500, 120, 6, 20)])
def test_popularity_baseline_is_jaxs(jax_tool, shape):
    from gsrs_tpu.data.sequences import synthetic_markov_sequences as jax_markov

    n, m, clusters, max_len = shape
    kw = dict(n_users=n, m_items=m, n_clusters=clusters, max_len=max_len, seed=11)
    got, want = synthetic_markov_sequences(**kw), jax_markov(**kw)
    for name in ("train_seqs", "eval_users", "eval_targets"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    topks = (1, 5, 10, 20)
    assert bench_seq_markov.popularity_baseline(got, topks) == \
        jax_tool.popularity_baseline(want, topks)


def test_rows_have_jaxs_keys(jax_tool, monkeypatch):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = bench_seq_markov.main(TINY + ["--device", CPU])
    assert _json_rows(buf.getvalue()) == json.loads(json.dumps(rows))
    monkeypatch.setattr(sys, "argv", [jax_tool.__file__] + TINY)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_tool.main()
    want = _json_rows(buf.getvalue())
    assert [r["model"] for r in rows] == [r["model"] for r in want] == [
        "chance", "popularity", *bench_seq_markov.KINDS]
    assert rows[:2] == want[:2]  # the same data: equal baselines
    for got, ref in zip(rows[2:], want[2:]):
        assert set(got) == set(ref) | {"launches"}
        assert got["epochs"] == 1 and got["train_s"] >= 0
        assert all(0 <= got[k] <= 1 for k in got if "@" in k and k.startswith(("recall", "ndcg")))
        assert got["vs_popularity_recall@10"] == round(
            got["recall@10"] / rows[1]["recall@10"], 2)
