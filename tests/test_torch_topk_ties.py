"""The port's ``exact`` top-k against ``lax.top_k`` on inputs full of ties.

`gsrs_tpu_torch.ops.topk.topk_scores(·, k, "exact")` must return the
values and ids of `gsrs_tpu.ops.topk.topk_scores(·, k, "exact")` (which is
``jax.lax.top_k``: descending, equal scores lowest column first, +0.0
above −0.0) bit for bit, at every k from 1 to m, on seeded standard
normals rounded to 0, 1 and 2 decimals (many ties, and −0.0 where a small
negative rounds to zero), with an all-zero row, an all −0.0 row, a row
mixing the two zeros, and a row whose maximum repeats more than m/2 times.
The same of `exact_topk_reference`, the CUDA kernel's plain version (its
composite key's order). Then a Retriever: an int8 artifact whose item table repeats its rows
(equal rows quantize to equal scores), served by the port and by the JAX
package, must give equal item ids.
"""

import numpy as np
import pytest
import torch

from gsrs_tpu_torch import serve as tserve
from gsrs_tpu_torch.ops import topk as ttopk
from gsrs_tpu_torch.ops.bitset import build_bitset

CPU = "cpu"
M = 37


@pytest.fixture
def jax_exact():
    pytest.importorskip("jax", reason="the JAX package is the reference")
    from gsrs_tpu.ops.topk import topk_scores

    return lambda scores, k: topk_scores(scores, k, "exact")


def _tie_rows(decimals: int) -> np.ndarray:
    rng = np.random.default_rng(100 + decimals)
    x = np.round(rng.standard_normal((8, M)), decimals).astype(np.float32)
    x[0] = 0.0
    x[1] = np.float32(-0.0)
    x[2] = np.where(rng.random(M) < 0.5, np.float32(-0.0), np.float32(0.0))
    x[3, rng.permutation(M)[: M // 2 + 3]] = x[3].max() + 1.0  # the maximum, 21 times
    return x


def _bitwise_equal(got, want):
    gv, gi = (t.numpy() for t in got)
    wv, wi = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gv.view(np.int32), wv.view(np.int32))  # −0.0 ≠ +0.0


@pytest.mark.parametrize("decimals", [0, 1, 2])
def test_exact_is_lax_top_k_bitwise(jax_exact, decimals):
    x = _tie_rows(decimals)
    assert (np.signbit(x) & (x == 0)).any()  # −0.0 is in the input
    for k in range(1, M + 1):
        _bitwise_equal(ttopk.topk_scores(torch.from_numpy(x), k, "exact"), jax_exact(x, k))


@pytest.mark.parametrize("decimals", [0, 1, 2])
def test_the_kernels_key_order_is_lax_top_k_bitwise(jax_exact, decimals):
    """`exact_topk_reference` (a sort of `topk_key`, the CUDA kernel's plain
    version) gives ``lax.top_k``'s values and ids, and `stable_topk`'s."""
    x = _tie_rows(decimals)
    for k in range(1, M + 1):
        got = ttopk.exact_topk_reference(torch.from_numpy(x), k)
        _bitwise_equal(got, jax_exact(x, k))
        _bitwise_equal(got, ttopk.stable_topk(torch.from_numpy(x), k))


def test_exact_sorts_only_the_rows_tied_at_k(jax_exact, monkeypatch):
    """A row whose k-th and (k + 1)-th values differ keeps torch.topk's
    set; only tied rows take the whole-row sort."""
    x = np.arange(4 * M, dtype=np.float32).reshape(4, M)
    x[2, :] = 1.0  # tied across every boundary
    sorted_rows = []
    original = ttopk.stable_topk

    def spy(scores, k):
        if scores.shape[1] == M:  # a whole row, not the k columns kept
            sorted_rows.append(scores.shape[0])
        return original(scores, k)

    monkeypatch.setattr(ttopk, "stable_topk", spy)
    _bitwise_equal(ttopk.topk_scores(torch.from_numpy(x), 5, "exact"), jax_exact(x, 5))
    assert sorted_rows == [1]


def test_order_key_is_the_total_order():
    v = torch.tensor([-np.inf, -1e9, -1.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, np.inf])
    key = ttopk.order_key(v)
    assert key.dtype == torch.int32 and bool((key[1:] > key[:-1]).all())
    half = v.to(torch.bfloat16)
    assert torch.equal(ttopk.order_key(half), ttopk.order_key(half.float()))
    ints = torch.tensor([[3, -1, 7]], dtype=torch.int32)
    assert torch.equal(ttopk.order_key(ints), ints)


def test_int8_retriever_with_repeated_items_matches_jax(tmp_path):
    pytest.importorskip("jax", reason="the JAX package is the reference")
    from gsrs_tpu import serve as jserve

    rng = np.random.default_rng(7)
    n, m, d = 12, 600, 8
    ue = rng.standard_normal((n, d)).astype(np.float32)
    ie = rng.standard_normal((24, d)).astype(np.float32)[rng.integers(0, 24, m)]  # repeated rows
    seen = build_bitset(rng.integers(0, n, 400), rng.integers(0, m, 400), n, m)
    path = str(tmp_path / "emb.npz")
    tserve.export_embeddings(tserve.Retriever(ue, ie, seen, device=CPU), path, quantize="int8")
    users = list(range(n))
    got_items, got_scores = tserve.load_retriever(path, batch_size=4, device=CPU).recommend(
        users, k=20)
    want_items, want_scores = jserve.load_retriever(path, batch_size=4).recommend(users, k=20)
    np.testing.assert_array_equal(got_items, want_items)
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-6)
    # every top-20 holds repeated items, so the order among them is what is checked
    assert all(len(set(ie[row].tobytes() for row in r)) < 20 for r in got_items)
