"""The ELL gather-reduce kernel's work list (`build_work_list`), built on
the CPU from the sides of the Gowalla-shaped stand-in, of a graph with a
row split at ``max_width`` and of hand-made rows around the split length
S: every real slot is covered exactly once and in slot order, no item
exceeds S slots, trailing padding is skipped and nothing else is, and the
two-pass sum rebuilt from the list in torch (fp32 partials, added in
chunk order) equals the plain gather-reduce within 1e-6. The plain
version is evaluated in float64 there: in fp32 the CPU's einsum over the
stand-in's widest row (29k slots) is itself 2.2e-6 off the exact sum,
the two-pass sum 3.3e-7. Rows of three or more ``max_width`` chunks add
their chunks one chunk level at a time, in JAX's order."""

import numpy as np
import pytest
import torch

from gsrs_tpu_torch.data import adjacency as tadj
from gsrs_tpu_torch.data import synthetic as tsyn
from gsrs_tpu_torch.ops import ell as tell
from gsrs_tpu_torch.ops.ell_kernel import (
    MAX_BUCKETS,
    SPLIT_SLOTS,
    build_work_list,
    gather_reduce_reference,
    real_lengths,
)

ATOL = 1e-6  # fp32, the order of summation only; sums are O(1)


def _covered(buckets, work):
    """Per bucket, how many items cover each slot (n_b, W) int64."""
    cover = [torch.zeros(w.shape, dtype=torch.int64) for _, w, _ in buckets]
    items = work.items.long()
    for b in range(len(buckets)):
        mine = items[items[:, 0] & 0xFF == b]
        n, row, j0 = mine[:, 0] >> 8, mine[:, 1], mine[:, 2]
        first = torch.cumsum(n, 0) - n
        slot = torch.arange(int(n.sum())) - torch.repeat_interleave(first, n)
        slot += torch.repeat_interleave(j0, n)
        flat = torch.repeat_interleave(row, n) * buckets[b][1].shape[1] + slot
        cover[b].view(-1).index_add_(0, flat, torch.ones_like(flat))
    return cover


def _check_work_list(buckets, split, row0=0):
    work = build_work_list(buckets, split, row0)
    items, splits = work.items.long(), work.splits.long()
    assert work.items.dtype == work.splits.dtype == torch.int32
    n = items[:, 0] >> 8
    assert int(n.max()) <= split
    assert bool((n[1:] <= n[:-1]).all())  # longest first
    # each real slot exactly once; trailing padding never; interior padding always
    for (_, w, _), cover in zip(buckets, _covered(buckets, work)):
        slot = torch.arange(w.shape[1])
        want = (slot[None, :] < real_lengths(w)[:, None]).long()
        assert torch.equal(cover, want)
        assert bool((cover[w != 0] == 1).all())
    # one item per row that is not split; a split row's chunks in slot order
    chunk = items[:, 3] >= 0
    assert int(chunk.sum()) == work.n_parts
    by_part = items[chunk][torch.argsort(items[chunk][:, 3])]
    assert torch.equal(by_part[:, 3], torch.arange(work.n_parts))
    for out_row, part0, k, zero in splits.tolist():
        run = by_part[part0:part0 + k]
        assert zero == 0 and k >= 2
        assert len(set((run[:, 0] & 0xFF).tolist())) == 1 and len(set(run[:, 1].tolist())) == 1
        assert torch.equal(run[:, 2], torch.arange(k) * split)
        assert bool(((run[:-1, 0] >> 8) == split).all())
    n_rows = sum(w.shape[0] for _, w, _ in buckets)
    assert int((~chunk).sum()) + splits.shape[0] == n_rows
    return work


def _two_pass_sum(buckets, work, x, row0=0):
    """The kernel's arithmetic in torch: each item's fp32 sum in slot
    order, whole rows stored, split rows' partials added in chunk order."""
    d = x.shape[1]
    n_rows = sum(w.shape[0] for _, w, _ in buckets)
    out = torch.full((row0 + n_rows, d), float("nan"))
    parts = torch.zeros(work.n_parts, d)
    firsts = np.cumsum([0] + [w.shape[0] for _, w, _ in buckets])
    for b, r, j0, part in work.items.long().tolist():
        bucket, n = b & 0xFF, b >> 8
        cols, w, _ = buckets[bucket]
        acc = torch.zeros(d)
        for j in range(j0, j0 + n):
            acc = acc + w[r, j] * x[cols[r, j]]
        if part < 0:
            out[row0 + firsts[bucket] + r] = acc
        else:
            parts[part] = acc
    for out_row, part0, k, _ in work.splits.long().tolist():
        acc = torch.zeros(d)
        for p in range(part0, part0 + k):
            acc = acc + parts[p]
        out[out_row] = acc
    return out[row0:]


def _two_pass_sum_fast(buckets, work, x):
    """_two_pass_sum, vectorised over items (each item's slots summed by
    index_add_ in fp32, the partials added in chunk order), for large
    sides."""
    d = x.shape[1]
    items = work.items.long()
    bucket, n, row, j0, part = items[:, 0] & 0xFF, items[:, 0] >> 8, items[:, 1], items[:, 2], \
        items[:, 3]
    sums = torch.zeros(items.shape[0], d)
    for b, (cols, w, _) in enumerate(buckets):
        sel = torch.nonzero(bucket == b).flatten()
        nb = n[sel]
        first = torch.cumsum(nb, 0) - nb
        slot = (torch.arange(int(nb.sum())) - torch.repeat_interleave(first, nb)
                + torch.repeat_interleave(j0[sel], nb))
        r = torch.repeat_interleave(row[sel], nb)
        contrib = w[r, slot][:, None] * x[cols[r, slot].long()]
        sums.index_add_(0, torch.repeat_interleave(sel, nb), contrib)
    firsts = torch.tensor(np.cumsum([0] + [w.shape[0] for _, w, _ in buckets]))
    out = torch.full((int(firsts[-1]), d), float("nan"))
    whole = part < 0
    out[firsts[bucket[whole]] + row[whole]] = sums[whole]
    parts = torch.zeros(work.n_parts, d)
    parts[part[~whole]] = sums[~whole]
    splits = work.splits.long()
    if splits.numel():
        acc = torch.zeros(splits.shape[0], d)
        for i in range(int(splits[:, 2].max())):
            live = splits[:, 2] > i
            acc[live] += parts[splits[live, 1] + i]
        out[splits[:, 0]] = acc
    return out


def _reference(buckets, x):
    """The plain gather-reduce of every bucket, in float64, as fp32."""
    return torch.cat([gather_reduce_reference(c, w.double(), x.double())
                      for c, w, _ in buckets]).float()


@pytest.fixture(scope="module")
def gowalla_sides():
    data = tsyn.powerlaw(29858, 40981, avg_degree=27, seed=2020, holdout_frac=0.2)
    ell = tell.ell_from_interactions(data)
    return {"by_user": (ell.by_user, data.m_items), "by_item": (ell.by_item, data.n_users)}


@pytest.mark.parametrize("side", ["by_user", "by_item"])
def test_gowalla_sides(gowalla_sides, side):
    ell_side, n_src = gowalla_sides[side]
    buckets = [(b.cols, b.w, b.eidx) for b in ell_side.buckets]
    assert len(buckets) <= MAX_BUCKETS
    work = _check_work_list(buckets, SPLIT_SLOTS)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((n_src, 4)).astype(np.float32))
    got = _two_pass_sum_fast(buckets, work, x)
    torch.testing.assert_close(got, _reference(buckets, x), atol=ATOL, rtol=0)
    if side == "by_item":
        assert work.splits.shape[0] > 0  # the widest items are split
    # the padding is what the list skips: slots covered = real edges
    assert int((work.items[:, 0].long() >> 8).sum()) == sum(int((w != 0).sum())
                                                           for _, w, _ in buckets)


def test_mega_row_graph():
    """A row wider than max_width is cut into virtual rows by the layout
    (extra_levels); the work list then cuts each of those at S."""
    n, m = 300, 400
    d = tsyn.powerlaw(n, m, seed=5)
    pairs = np.unique(np.concatenate([np.stack([d.train_users, d.train_items], 1),
                                      np.stack([np.arange(n), np.full(n, 17)], 1)]), axis=0)
    users, items = pairs[:, 0], pairs[:, 1]
    w = tadj.normalized_edge_weights(users, items, np.bincount(users, minlength=n),
                                     np.bincount(items, minlength=m))
    g = tell.build_ell_graph(users.astype(np.int32), items.astype(np.int32), w, n, m, 4, 128)
    assert g.by_item.extra_levels
    buckets = [(b.cols, b.w, b.eidx) for b in g.by_item.buckets]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((n, 3)).astype(np.float32))
    for split in (32, 64, SPLIT_SLOTS):
        work = _check_work_list(buckets, split)
        torch.testing.assert_close(_two_pass_sum(buckets, work, x), _reference(buckets, x),
                                   atol=ATOL, rtol=0)
    assert build_work_list(buckets, 32).splits.shape[0] > 0


def _jax_chunk_pairs(j_side):
    """The JAX side's (extra_dst, extra_pos) pairs, each row's chunks in
    chunk order."""
    return list(zip(np.asarray(j_side.extra_dst).tolist(), np.asarray(j_side.extra_pos).tolist()))


@pytest.mark.parametrize("max_width", [8, 16])
def test_wide_row_chunks_add_in_chunk_order_as_jax(max_width):
    """Rows of three or more chunks (two hub items, of 300 and 150 users,
    at a small max_width): the overflow chunks are grouped into chunk
    levels whose rows are distinct (one `index_add_` a level, no repeated
    index), the levels hold exactly the JAX package's (extra_dst,
    extra_pos) pairs, the side's output is each row's chunks added left to
    right in chunk order (bitwise, against that sum rebuilt here), equal to
    JAX's `.at[].add` within fp32 order, and two applies are bitwise
    equal."""
    pytest.importorskip("jax", reason="the JAX package is the reference this test compares with")
    import jax.numpy as jnp

    from gsrs_tpu.ops import ell as jell
    from gsrs_tpu_torch.ops.ell_kernel import gather_reduce

    n, m = 300, 400
    d = tsyn.powerlaw(n, m, seed=7)
    pairs = np.unique(np.concatenate([
        np.stack([d.train_users, d.train_items], 1),
        np.stack([np.arange(n), np.full(n, 17)], 1),
        np.stack([np.arange(0, n, 2), np.full(n // 2, 3)], 1),
    ]), axis=0)
    users, items = pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32)
    w = tadj.normalized_edge_weights(users, items, np.bincount(users, minlength=n),
                                     np.bincount(items, minlength=m))
    args = (users, items, w, n, m, 4, max_width)
    t_side, j_side = tell.build_ell_graph(*args).by_item, jell.build_ell_graph(*args).by_item

    levels = t_side.extra_levels
    assert len(levels) == -(-n // max_width) - 1 >= 2  # the widest row has 3+ chunks
    for dst, pos in levels:
        assert dst.unique().numel() == dst.numel()
    got_pairs = sorted((int(a), int(b)) for dst, pos in levels for a, b in zip(dst, pos))
    assert got_pairs == sorted(_jax_chunk_pairs(j_side))
    for r in (17, 3):  # level j holds chunk j + 1: JAX's order of the row's chunks
        chunks = [int(p[dst == r]) for dst, p in levels if bool((dst == r).any())]
        want = [p for dst, p in _jax_chunk_pairs(j_side) if dst == r]
        assert chunks == want and len(chunks) == -(-int((items == r).sum()) // max_width) - 1

    x = torch.from_numpy(np.random.default_rng(3).standard_normal((n, 5)).astype(np.float32))
    out = tell._apply_side(t_side, x)
    assert torch.equal(out, tell._apply_side(t_side, x))
    concat = x.new_zeros(t_side.table.n_rows + 1, 5)
    gather_reduce(t_side.table, x, out=concat)
    want = concat.index_select(0, t_side.assemble)
    for dst, pos in levels:
        for r, p in zip(dst.tolist(), pos.tolist()):
            want[r] = want[r] + concat[p]
    assert torch.equal(out, want)
    j_out = np.asarray(jell._apply_side(j_side, jnp.asarray(x.numpy()), None))
    np.testing.assert_allclose(out.numpy(), j_out, rtol=1e-5, atol=1e-6)


def _rows_around_split(S, seed=0):
    """One bucket of width 2S + 64: rows of exactly S, S + 1 and 2S real
    slots, a row that is padding after slot 1, a row of padding only, a
    full row, and one with interior zero weights."""
    W = 2 * S + 64
    g = torch.Generator().manual_seed(seed)
    cols = torch.randint(0, 50, (7, W), generator=g, dtype=torch.int32)
    w = (torch.rand(7, W, generator=g) + 0.1) / W**0.5  # a normalized adjacency's scale
    for r, length in enumerate((S, S + 1, 2 * S, 1, 0, W, S + 40)):
        cols[r, length:], w[r, length:] = 0, 0.0
    w[6, 5:S] = 0.0  # interior zeros: still summed
    return [(cols, w, torch.zeros_like(cols))]


@pytest.mark.parametrize("S", [32, 64, SPLIT_SLOTS])
def test_rows_around_the_split_length(S):
    buckets = _rows_around_split(S)
    work = _check_work_list(buckets, S, row0=5)
    length = real_lengths(buckets[0][1]).tolist()
    assert length == [S, S + 1, 2 * S, 1, 0, 2 * S + 64, S + 40]
    split_rows = sorted(r - 5 for r in work.splits[:, 0].tolist())
    assert split_rows == [1, 2, 5, 6]
    want_parts = [-(-length[r] // S) for r in (1, 2, 5, 6)]
    assert [k for _, k in sorted((r, k) for r, _, k, _ in work.splits.tolist())] == want_parts
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((50, 5)).astype(np.float32))
    torch.testing.assert_close(_two_pass_sum(buckets, work, x, row0=5), _reference(buckets, x),
                               atol=ATOL, rtol=0)


def test_work_list_rejects_what_the_kernel_cannot_take():
    buckets = _rows_around_split(32)
    for split in (0, 48, 2**23):
        with pytest.raises(ValueError, match="split"):
            build_work_list(buckets, split)
    with pytest.raises(ValueError, match="at most"):
        build_work_list(buckets * (MAX_BUCKETS + 1))
    empty = build_work_list([])
    assert empty.items.shape == (0, 4) and empty.splits.shape == (0, 4) and empty.n_parts == 0
