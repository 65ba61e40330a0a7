"""The port's mesh-even padding and sharded ELL layout against the JAX
package's, in one process: `pad_nodes_to_multiple`, `pad_ell_graph` and
`shard_ell_graph` give the JAX package's arrays element for element
(rows wider than ``max_width`` split into overflow chunks included), each
shard's `apply_sharded_side_local` equals JAX's within 1e-6 (fp32 sums
of a few O(1) terms in another order) and the shards' partials sum to
the unsharded apply within 1e-5 (JAX's own limit for it); a shard's
`EllSide` (`ShardedEllSide.local`) adds its overflow chunks one chunk
level at a time. `bitset_columns` reads a catalog shard's columns out of
the packed words at any offset."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="the JAX package is the reference these tests compare with")

import jax.numpy as jnp  # noqa: E402

from gsrs_tpu.data.dataset import pad_nodes_to_multiple as jpad_nodes
from gsrs_tpu.data.synthetic import clustered as jclustered
from gsrs_tpu.ops import ell as jell
from gsrs_tpu_torch.data.dataset import pad_nodes_to_multiple
from gsrs_tpu_torch.data.synthetic import clustered
from gsrs_tpu_torch.ops import ell as tell
from gsrs_tpu_torch.ops.bitset import (
    bitset_columns, bitset_row_mask, bitset_to_tensor, build_bitset,
)

APPLY_ATOL = SUM_ATOL = 1e-5


def graphs(max_width):
    """The same weighted edges (two hub rows on each side, wider than
    ``max_width`` = 8) in both packages' ELL form."""
    rng = np.random.default_rng(0)
    n, m = 40, 30
    mask = rng.random((n, m)) < 0.2
    mask[0, :] = mask[7, :] = True
    mask[:, 1] = mask[:, 3] = True
    u, i = np.nonzero(mask)
    w = rng.random(u.size).astype(np.float32)
    args = (u.astype(np.int32), i.astype(np.int32), w, n, m, 4, max_width)
    return jell.build_ell_graph(*args), tell.build_ell_graph(*args)


def assert_side_equal(j, t):
    for name in ("cols", "w", "eidx"):
        for a, b in zip(getattr(j, name), getattr(t, name)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    np.testing.assert_array_equal(np.asarray(j.assemble), t.assemble.numpy())
    assert (j.n_rows, j.local_len, j.n_shards) == (t.n_rows, t.local_len, t.n_shards)
    assert (j.extra_dst is None) == (t.extra_dst is None)
    if j.extra_dst is not None:
        np.testing.assert_array_equal(np.asarray(j.extra_dst), t.extra_dst.numpy())
        np.testing.assert_array_equal(np.asarray(j.extra_pos), t.extra_pos.numpy())


@pytest.mark.parametrize("multiple", [1, 3, 4, 8])
def test_pad_nodes_to_multiple_matches_jax(multiple):
    j = jpad_nodes(jclustered(61, 97, n_clusters=4, seed=3), multiple)
    t = pad_nodes_to_multiple(clustered(61, 97, n_clusters=4, seed=3), multiple)
    for name in ("n_users", "m_items", "real_n_users", "real_m_items"):
        assert getattr(t, name) == getattr(j, name), name
    np.testing.assert_array_equal(t.train_users, j.train_users)
    # the phantom columns are masked in the sampler's and evaluator's bitset
    bits = build_bitset(t.train_users, t.train_items, t.n_users, t.m_items,
                        real_m_items=t.real_m_items)
    if t.m_items > 97:
        mask = bitset_row_mask(bitset_to_tensor(bits, "cpu"), t.m_items)
        assert bool(mask[:, 97:].all())


@pytest.mark.parametrize("max_width", [8, 65536])
@pytest.mark.parametrize("multiple", [1, 3, 4])
def test_pad_ell_graph_matches_jax(max_width, multiple):
    jg, tg = graphs(max_width)
    jp, tp = jell.pad_ell_graph(jg, multiple), tell.pad_ell_graph(tg, multiple)
    for js, ts in ((jp.by_user, tp.by_user), (jp.by_item, tp.by_item)):
        np.testing.assert_array_equal(np.asarray(js.assemble), ts.assemble.numpy())
        for jb, tb in zip(js.buckets, ts.buckets):
            assert tb.cols.shape[0] % multiple == 0
            for name in ("rows", "cols", "w", "eidx"):
                np.testing.assert_array_equal(np.asarray(getattr(jb, name)),
                                              getattr(tb, name).numpy())
        if js.extra_dst is not None:
            dst, pos = tell.flat_extras(ts)
            np.testing.assert_array_equal(np.asarray(js.extra_dst), dst)
            np.testing.assert_array_equal(np.asarray(js.extra_pos), pos)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(30, 8)).astype(np.float32))
    np.testing.assert_allclose(tell._apply_side(tp.by_user, x).numpy(),
                               tell._apply_side(tg.by_user, x).numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("max_width", [8, 65536])
@pytest.mark.parametrize("n_shards", [1, 3, 4, 8])
def test_shard_ell_graph_arrays_equal_jax(max_width, n_shards):
    jg, tg = graphs(max_width)
    js, ts = jell.shard_ell_graph(jg, n_shards), tell.shard_ell_graph(tg, n_shards)
    assert_side_equal(js.by_user, ts.by_user)
    assert_side_equal(js.by_item, ts.by_item)
    if max_width == 8:
        assert ts.by_user.extra_dst is not None and ts.by_item.extra_dst is not None


@pytest.mark.parametrize("max_width", [8, 65536])
@pytest.mark.parametrize("masked", [False, True])
def test_shard_partials_match_jax_and_sum_to_the_apply(max_width, masked):
    jg, tg = graphs(max_width)
    rng = np.random.default_rng(2)
    n_edges = int(sum((np.asarray(b.w) != 0).sum() for b in jg.by_user.buckets))
    keep = (rng.random(n_edges) < 0.6).astype(np.float32) / 0.6 if masked else None
    for n_shards in (3, 4):
        js, ts = jell.shard_ell_graph(jg, n_shards), tell.shard_ell_graph(tg, n_shards)
        for jside, tside, rows, src in ((js.by_user, ts.by_user, 40, 30),
                                        (js.by_item, ts.by_item, 30, 40)):
            x = rng.normal(size=(src, 8)).astype(np.float32)
            mask_j = None if keep is None else jnp.asarray(keep)
            mask_t = None if keep is None else torch.from_numpy(keep)
            whole = tell._apply_side(tg.by_user if rows == 40 else tg.by_item,
                                     torch.from_numpy(x), mask_t)
            total = torch.zeros(rows, 8)
            for s in range(n_shards):
                def part(t):
                    return t.reshape(n_shards, -1, *t.shape[1:])[s]

                extra = (None, None) if jside.extra_dst is None else (
                    jside.extra_dst[s], jside.extra_pos[s])
                want = jell.apply_sharded_side_local(
                    tuple(map(part, jside.cols)), tuple(map(part, jside.w)),
                    tuple(map(part, jside.eidx)), jside.assemble[s], jnp.asarray(x), mask_j,
                    *extra)
                t_extra = (None, None) if tside.extra_dst is None else (
                    tside.extra_dst[s], tside.extra_pos[s])
                got = tell.apply_sharded_side_local(
                    [part(c) for c in tside.cols], [part(c) for c in tside.w],
                    [part(c) for c in tside.eidx], tside.assemble[s], torch.from_numpy(x),
                    mask_t, *t_extra)
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                           atol=APPLY_ATOL)
                local = tside.local(s)
                np.testing.assert_allclose(tell._apply_side(local, torch.from_numpy(x),
                                                            mask_t).numpy(),
                                           got.numpy(), rtol=0, atol=0)
                for level_dst, _ in local.extra_levels:
                    assert level_dst.unique().numel() == level_dst.numel()
                total += got
            np.testing.assert_allclose(total.numpy(), whole.numpy(), rtol=0, atol=SUM_ATOL)


def test_bitset_columns_reads_any_column_range():
    rng = np.random.default_rng(4)
    for m in (1, 31, 32, 33, 100, 257):
        u, i = rng.integers(0, 7, 200), rng.integers(0, m, 200)
        words = bitset_to_tensor(build_bitset(u, i, 7, m), "cpu")
        full = bitset_row_mask(words, m)
        for lo in range(0, m, 3):
            for hi in {lo + 1, min(m, lo + 5), min(m, lo + 40), m}:
                if hi <= lo or hi > m:
                    continue
                cols = bitset_columns(words, lo, hi)
                assert cols.shape == (7, (hi - lo + 31) // 32) and cols.dtype == torch.int32
                assert torch.equal(bitset_row_mask(cols, hi - lo), full[:, lo:hi])
                tail = (hi - lo) % 32
                if tail:  # the bits past the range are 0
                    assert bool(((cols[:, -1].long() & 0xFFFFFFFF) >> tail == 0).all())
    with pytest.raises(ValueError, match="outside"):
        bitset_columns(words, 0, 32 * words.shape[1] + 1)
