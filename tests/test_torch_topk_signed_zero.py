"""The port's ranking paths against ``lax.top_k`` where −0.0 and +0.0 meet
at the k-th boundary.

``lax.top_k`` compares floats in XLA's total order, so −0.0 ranks below
+0.0; a float sort holds them equal and keeps the lower column first.
Every input here holds 19 scores of 1.0, −1.0 elsewhere, and −0.0 and
+0.0 at two more columns, the −0.0 at the lower column in the first row,
so the 20th and 21st ids are the two zeros in one order or the other.
Each path of the port must return the JAX function's ids and values bit
for bit (−0.0 ≠ +0.0) on the same numpy input:

- `topk_threshold` on its candidate path (m = 3,000), on its small-m
  return (m = 800), and on the whole batch's fallback (rounded normals
  with an all-zero row, an all −0.0 row and a row mixing them, whose
  count never lands in the band);
- `topk_scores(·, "approx")` at r = 0 (m = 100) and with the two zeros in
  different bins of the fold (JAX's CPU ``approx_max_k`` is exact, and
  each top-k score wins a bin of its own here);
- `merge_topk` on one rank, its candidates in shuffled id order;
- `exact_topk_reference` (the exact CUDA kernel's plain version: a sort of
  its 64-bit key) on the boundary rows and the rounded rows;
- the Evaluator's batch path without its GEMM: `mask_train_positives`
  then ``threshold`` on the same scores and bitset rows (the two GEMMs
  disagree on the sign of a zero, so the scores are handed to both).

The mesh's merge on four ranks is in tests/test_torch_parallel_mesh.py.
"""

import numpy as np
import pytest
import torch

from gsrs_tpu_torch.ops import topk as ttopk
from gsrs_tpu_torch.ops.bitset import build_bitset
from gsrs_tpu_torch.parallel.collectives import merge_topk
from gsrs_tpu_torch.parallel.mesh import single_device_mesh

ONES = 19
NEG_ZERO = np.float32(-0.0)


@pytest.fixture
def jtopk():
    pytest.importorskip("jax", reason="the JAX package is the reference")
    from gsrs_tpu.ops import topk

    return topk


def boundary_rows(m: int, n_rows: int, seed: int, bins: int = None) -> np.ndarray:
    """(n_rows, m) float32: −1.0, then 1.0 at ONES columns and −0.0 and
    +0.0 at two more; row 0 puts −0.0 at column 5 and +0.0 at column 7.
    With ``bins``, the ONES + 2 columns fall in distinct bins (column mod
    bins), the ones at fold 0 and the zeros at any fold."""
    rng = np.random.default_rng(seed)
    x = np.full((n_rows, m), -1.0, np.float32)
    for r in range(n_rows):
        pool = np.arange(bins or m)
        cols = rng.permutation(np.setdiff1d(pool, [5, 7]) if r == 0 else pool)[: ONES + 2]
        if r == 0:
            cols[ONES:] = [5, 7]
        elif bins is not None:
            folds = (m - 1 - cols[ONES:]) // bins + 1  # folds holding a real column
            cols[ONES:] += bins * rng.integers(0, folds)
        x[r, cols[:ONES]] = 1.0
        x[r, cols[ONES]] = NEG_ZERO
        x[r, cols[ONES + 1]] = 0.0
    return x


def tie_rows(m: int, decimals: int) -> np.ndarray:
    """Seeded normals rounded to ``decimals`` (−0.0 where a small negative
    rounds to zero), with an all-zero row, an all −0.0 row and a row
    mixing the two zeros."""
    rng = np.random.default_rng(200 + decimals)
    x = np.round(rng.standard_normal((6, m)), decimals).astype(np.float32)
    x[0] = 0.0
    x[1] = NEG_ZERO
    x[2] = np.where(rng.random(m) < 0.5, NEG_ZERO, np.float32(0.0))
    return x


def assert_bitwise(got, want):
    gv, gi = (t.numpy() for t in got)
    wv, wi = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gv.view(np.int32), wv.view(np.int32))  # −0.0 ≠ +0.0


@pytest.fixture
def candidate_calls(monkeypatch):
    """How often `topk_threshold` took its candidate path."""
    calls = []
    real = ttopk._threshold_candidates

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(ttopk, "_threshold_candidates", spy)
    return calls


def has_both_zeros(x: np.ndarray) -> bool:
    zero = x == 0
    return bool((zero & np.signbit(x)).any() and (zero & ~np.signbit(x)).any())


@pytest.mark.parametrize("k", [20, 21])
@pytest.mark.parametrize("m, path", [(3000, "candidates"), (800, "small_m")])
def test_threshold_ranks_the_zeros_as_lax_top_k(jtopk, candidate_calls, k, m, path):
    x = boundary_rows(m, 4, seed=m + k)
    assert_bitwise(ttopk.topk_threshold(torch.from_numpy(x), k), jtopk.topk_threshold(x, k))
    assert len(candidate_calls) == (path == "candidates")


@pytest.mark.parametrize("decimals", [0, 1, 2])
def test_threshold_whole_batch_fallback_ranks_the_zeros_as_lax_top_k(jtopk, candidate_calls,
                                                                     decimals):
    x = tie_rows(3000, decimals)
    assert has_both_zeros(x[2])
    for k in (1, 20, 21, 256):
        assert_bitwise(ttopk.topk_threshold(torch.from_numpy(x), k), jtopk.topk_threshold(x, k))
    assert candidate_calls == []  # the mixed row's count never lands in [k, cap]


@pytest.mark.parametrize("k", [20, 21])
def test_approx_without_a_fold_ranks_the_zeros_as_lax_top_k(jtopk, k):
    x = boundary_rows(100, 4, seed=k)
    assert ttopk.approx_bins(100, k, 0.95)[1] == 0
    assert_bitwise(ttopk.topk_scores(torch.from_numpy(x), k, "approx"),
                   jtopk.topk_scores(x, k, "approx"))


@pytest.mark.parametrize("k", [20, 21])
def test_approx_bins_rank_the_zeros_as_lax_top_k(jtopk, k):
    m = 3000
    bins, r = ttopk.approx_bins(m, k, 0.95)
    assert r > 0  # the row folds 2^r times
    x = boundary_rows(m, 8, seed=10 + k, bins=bins)
    zero_bins = [np.flatnonzero(row == 0) % bins for row in x]
    assert all(len(set(b)) == 2 for b in zero_bins)
    assert_bitwise(ttopk.topk_scores(torch.from_numpy(x), k, "approx"),
                   jtopk.topk_scores(x, k, "approx"))


@pytest.mark.parametrize("k", [20, 21])
def test_merge_on_one_rank_ranks_the_zeros_as_lax_top_k(jtopk, k):
    import jax

    x = boundary_rows(64, 4, seed=30 + k)
    perm = np.random.default_rng(k).permutation(64)
    ids = torch.from_numpy(np.tile(perm, (4, 1)))
    got = merge_topk(torch.from_numpy(x[:, perm]), ids, k, single_device_mesh("cpu"))
    assert_bitwise(got, jax.lax.top_k(x, k))


@pytest.mark.parametrize("k", [20, 21])
@pytest.mark.parametrize("rows", ["boundary", "ties_0", "ties_1", "ties_2"])
def test_the_kernels_key_order_ranks_the_zeros_as_lax_top_k(jtopk, rows, k):
    """`exact_topk_reference` (the exact CUDA kernel's plain version) on the
    boundary rows and on the rounded rows with their zero rows."""
    import jax

    x = boundary_rows(3000, 4, seed=50 + k) if rows == "boundary" else tie_rows(
        3000, int(rows[-1]))
    assert has_both_zeros(x[0] if rows == "boundary" else x[2])
    assert_bitwise(ttopk.exact_topk_reference(torch.from_numpy(x), k), jax.lax.top_k(x, k))


def test_evaluator_batch_without_its_gemm_ranks_the_zeros_as_lax_top_k(jtopk, candidate_calls):
    """Masked entries (−1e9) sit among the ones, the boundary's two
    zeros stay unmasked: 6 more ones and 40 columns of −1.0 are masked."""
    m, k, B = 3000, 20, 8
    rng = np.random.default_rng(5)
    x = boundary_rows(m, B, seed=40)
    users, items = [], []
    for r in range(B):
        minus = np.flatnonzero(x[r] == -1.0)
        extra = rng.choice(minus, 6, replace=False)
        x[r, extra] = 1.0
        hidden = np.concatenate([extra, rng.choice(np.setdiff1d(minus, extra), 40,
                                                   replace=False)])
        users += [r] * hidden.size
        items += hidden.tolist()
    seen = build_bitset(np.array(users), np.array(items), B, m)
    got = ttopk.topk_scores(ttopk.mask_train_positives(
        torch.from_numpy(x), torch.from_numpy(seen.view(np.int32)), m), k, "threshold")
    want = jtopk.topk_scores(jtopk.mask_train_positives(x, seen, m), k, "threshold")
    assert_bitwise(got, want)
    assert len(candidate_calls) == 1
    vals = got[0].numpy()
    assert (vals > ttopk.NEG_INF).all() and (vals[:, k - 1] == 0).all()  # the zeros at the k-th
