"""The port's ELL layer as an autograd Function against the JAX package's
custom VJP: forward outputs and input gradients for the same cotangents,
with and without an edge mask, on a power-law graph and on one with a
split mega row; the plain gather-reduce against the JAX einsum per bucket;
and (marked ``gpu``, on a CUDA card only) the hand-written CUDA kernel
against the plain version."""

import numpy as np
import pytest
import torch

from gsrs_tpu_torch.data import adjacency as tadj
from gsrs_tpu_torch.data import synthetic as tsyn
from gsrs_tpu_torch.ops import ell as tell
from gsrs_tpu_torch.ops import ell_kernel
from gsrs_tpu_torch.ops.ell_kernel import BucketTable, gather_reduce, gather_reduce_reference

ATOL = 1e-6  # fp32, summation order only; values are O(1)
# kernel vs plain on the card: fp32 sums in another order (1e-5), and in bf16 one rounding of
# the fp32 sum to bf16 (2^-8 relative) on top
CARD_ATOL, CARD_BF16_RTOL = 1e-5, 2.0**-8


@pytest.fixture
def jax_ell():
    pytest.importorskip("jax", reason="the JAX package is the reference these tests compare with")
    from gsrs_tpu.ops import ell

    return ell


def _graphs(case, jell):
    """(port graph, JAX graph, n, m): a power-law graph, or one where
    every user also rated item 17, whose row (200 wide) is split at 8."""
    n, m = 200, 300
    d = tsyn.powerlaw(n, m, seed=5)
    pairs = np.stack([d.train_users, d.train_items], 1)
    if case == "mega_row":
        pairs = np.unique(np.concatenate([pairs, np.stack([np.arange(n), np.full(n, 17)], 1)]),
                          axis=0)
    users, items = pairs[:, 0], pairs[:, 1]
    w = tadj.normalized_edge_weights(users, items, np.bincount(users, minlength=n),
                                     np.bincount(items, minlength=m))
    args = (users.astype(np.int32), items.astype(np.int32), w, n, m, 4,
            8 if case == "mega_row" else 65536)
    return tell.build_ell_graph(*args), jell.build_ell_graph(*args), n, m, users.size


@pytest.mark.parametrize("case", ["powerlaw", "mega_row"])
@pytest.mark.parametrize("masked", [False, True])
def test_layer_forward_and_vjp_match_jax(jax_ell, case, masked):
    import jax
    import jax.numpy as jnp

    tg, jg, n, m, E = _graphs(case, jax_ell)
    if case == "mega_row":
        assert tg.by_item.extra_levels
    rng = np.random.default_rng(11)
    d = 16
    u, i = (rng.standard_normal((k, d)).astype(np.float32) for k in (n, m))
    gu, gi = (rng.standard_normal((k, d)).astype(np.float32) for k in (n, m))
    mask = ((rng.random(E) < 0.6) / 0.6).astype(np.float32) if masked else None

    jmask = None if mask is None else jnp.asarray(mask)
    (ju, ji), vjp = jax.vjp(lambda a, b: jax_ell.ell_propagate_layer(jg, a, b, jmask),
                            jnp.asarray(u), jnp.asarray(i))
    jdu, jdi = vjp((jnp.asarray(gu), jnp.asarray(gi)))

    tu_in = torch.from_numpy(u).requires_grad_()
    ti_in = torch.from_numpy(i).requires_grad_()
    tmask = None if mask is None else torch.from_numpy(mask)
    tu, ti = tell.ell_propagate_layer(tg, tu_in, ti_in, tmask)
    torch.autograd.backward((tu, ti), (torch.from_numpy(gu), torch.from_numpy(gi)))

    for got, want in ((tu, ju), (ti, ji), (tu_in.grad, jdu), (ti_in.grad, jdi)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_backward_is_the_transpose_apply(jax_ell):
    """<W x, g> = <x, W^T g> through the autograd Function, in bf16 the
    gradients keep each input's dtype."""
    tg, _, n, m, _ = _graphs("mega_row", jax_ell)
    g = torch.Generator().manual_seed(0)
    u = torch.randn(n, 8, generator=g).requires_grad_()
    i = torch.randn(m, 8, generator=g).requires_grad_()
    new_u, new_i = tell.ell_propagate_layer(tg, u, i)
    (new_u.sum() + 2 * new_i.sum()).backward()
    ones_u, ones_i = torch.ones(n, 8), torch.ones(m, 8)
    np.testing.assert_allclose(i.grad.numpy(),
                               tell._apply_side(tg.by_item, ones_u).numpy(), atol=ATOL)
    np.testing.assert_allclose(u.grad.numpy(),
                               tell._apply_side(tg.by_user, 2 * ones_i).numpy(), atol=ATOL)
    ub, ib = u.detach().bfloat16().requires_grad_(), i.detach().bfloat16().requires_grad_()
    bu, bi = tell.ell_propagate_layer(tg, ub, ib)
    (bu.float().sum() + bi.float().sum()).backward()
    assert bu.dtype == bi.dtype == ub.grad.dtype == ib.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("masked", [False, True])
def test_reference_matches_jax_einsum_per_bucket(jax_ell, masked):
    import jax.numpy as jnp

    tg, jg, n, m, E = _graphs("powerlaw", jax_ell)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((m, 12)).astype(np.float32)
    mask = (rng.random(E) < 0.5).astype(np.float32) * 2 if masked else None
    for tb, jb in zip(tg.by_user.buckets, jg.by_user.buckets):
        w = jb.w if mask is None else jb.w * jnp.asarray(mask)[jb.eidx]
        want = jnp.einsum("nd,ndk->nk", w, jnp.take(jnp.asarray(x), jb.cols.reshape(-1), axis=0)
                          .reshape(*jb.cols.shape, 12))
        got = gather_reduce_reference(tb.cols, tb.w, torch.from_numpy(x),
                                      None if mask is None else torch.from_numpy(mask), tb.eidx)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_table_stacks_buckets_and_checks_inputs():
    """gather_reduce writes bucket after bucket and leaves rows past
    them alone; bad shapes, dtypes, index ranges and devices raise."""
    g = torch.Generator().manual_seed(1)
    b1 = (torch.randint(0, 5, (3, 4), generator=g, dtype=torch.int32), torch.rand(3, 4),
          torch.zeros(3, 4, dtype=torch.int32))
    b2 = (torch.randint(0, 5, (2, 8), generator=g, dtype=torch.int32), torch.rand(2, 8),
          torch.arange(16, dtype=torch.int32).reshape(2, 8))
    table = BucketTable([b1, b2])
    x = torch.randn(5, 3, generator=g)
    out = torch.full((6, 3), 7.0)
    gather_reduce(table, x, out=out)
    want = torch.cat([gather_reduce_reference(*b1[:2], x), gather_reduce_reference(*b2[:2], x)])
    assert torch.equal(out[:5], want) and torch.equal(out[5], torch.full((3,), 7.0))
    with pytest.raises(ValueError, match="rows"):
        gather_reduce(table, torch.randn(4, 3))
    with pytest.raises(ValueError, match="mask"):
        gather_reduce(table, x, mask=torch.ones(15))
    with pytest.raises(ValueError, match="out"):
        gather_reduce(table, x, out=torch.empty(4, 3))
    with pytest.raises(TypeError):
        gather_reduce(table, x, out=torch.empty(5, 3, dtype=torch.float64))
    with pytest.raises(TypeError):
        BucketTable([(b1[0].long(), b1[1], b1[2])])
    with pytest.raises(ValueError, match="on meta"):
        gather_reduce(table, x.to("meta"))


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ with no CPU mode")
    return torch.device("cuda:0")


def _card_table(dev, widths_rows, S, E, seed):
    """Buckets of the given (width, rows) with a third of the slots
    padding (column 0, weight 0), on ``dev``. Weights are U(0, 1)/√W,
    the scale of a normalized adjacency, so the sums stay O(1)."""
    g = torch.Generator().manual_seed(seed)
    buckets = []
    for W, n in widths_rows:
        cols = torch.randint(0, S, (n, W), generator=g, dtype=torch.int32)
        w = torch.rand(n, W, generator=g) / W**0.5
        pad = torch.rand(n, W, generator=g) < 0.33
        cols[pad], w[pad] = 0, 0.0
        eidx = torch.randint(0, E, (n, W), generator=g, dtype=torch.int32)
        buckets.append(tuple(t.to(dev) for t in (cols, w, eidx)))
    return BucketTable(buckets)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 40, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_matches_reference_on_the_card(cuda, d, dtype, masked):
    S, E = 3000, 5000
    table = _card_table(cuda, [(4, 100), (36, 33), (128, 9), (512, 3), (4096, 2)], S, E, d)
    g = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn(S, d, device=cuda, generator=g).to(dtype)
    mask = (torch.rand(E, device=cuda, generator=g) < 0.6).float() / 0.6 if masked else None
    before = ell_kernel.LAUNCHES["ell_gather_reduce"]
    got = gather_reduce(table, x, mask)
    torch.cuda.synchronize()
    assert ell_kernel.LAUNCHES["ell_gather_reduce"] == before + 1
    assert got.dtype == dtype
    _assert_matches_fp32_sum(got, table, x, mask)


def _fp32_sum(table, x, mask):
    """The fp32 sum of every bucket with the masked weights rounded to
    x's dtype first, as the JAX einsum and the kernel round them."""
    return torch.cat([gather_reduce_reference(
        c, (w if mask is None else w * mask[e]).to(x.dtype).float(), x.float())
        for c, w, e in table.buckets])


def _assert_matches_fp32_sum(got, table, x, mask):
    """fp32: that sum within CARD_ATOL; bf16: that sum rounded once."""
    want = _fp32_sum(table, x, mask)
    rtol = 0 if x.dtype == torch.float32 else CARD_BF16_RTOL
    torch.testing.assert_close(got.float(), want, atol=CARD_ATOL, rtol=rtol)


@pytest.mark.gpu
def test_kernel_launches_once_per_64_buckets(cuda):
    """A side of more than 64 buckets takes one launch per table of 64;
    the rows still stack in bucket order."""
    S, E = 500, 800
    table = _card_table(cuda, [(4 + 4 * (i % 16), 3 + i % 5) for i in range(70)], S, E, 3)
    x = torch.randn(S, 32, device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    before = ell_kernel.LAUNCHES["ell_gather_reduce"]
    got = gather_reduce(table, x)
    torch.cuda.synchronize()
    assert ell_kernel.LAUNCHES["ell_gather_reduce"] == before + 2
    want = torch.cat([gather_reduce_reference(c, w, x) for c, w, _ in table.buckets])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_layer_gradients_on_the_card_match_the_cpu(cuda):
    data = tsyn.powerlaw(500, 700, avg_degree=12, seed=2)
    graph = tell.ell_from_interactions(data)
    g = torch.Generator().manual_seed(0)
    u, i = torch.randn(500, 64, generator=g), torch.randn(700, 64, generator=g)
    gu, gi = torch.randn(500, 64, generator=g), torch.randn(700, 64, generator=g)
    grads = []
    for dev, gr in ((torch.device("cpu"), graph), (cuda, graph.to(cuda))):
        a, b = (t.detach().clone().to(dev).requires_grad_() for t in (u, i))
        out = tell.ell_propagate_layer(gr, a, b)
        torch.autograd.backward(out, (gu.to(dev), gi.to(dev)))
        grads.append([t.detach().cpu() for t in (*out, a.grad, b.grad)])
    for got, want in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    table = _card_table(cuda, [(8, 4)], 10, 10, 0)
    x = torch.randn(10, 16, device=cuda)
    with pytest.raises(TypeError):
        gather_reduce(table, x.double())
    with pytest.raises(TypeError):
        gather_reduce(table, x, mask=torch.ones(10, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        gather_reduce(table, torch.randn(16, 10, device=cuda).T)
    with pytest.raises(ValueError, match="is on cpu"):
        gather_reduce(table, x.cpu())


def _split_rows_table(dev, S, seed):
    """Rows of exactly S, S + 1 and 2S real slots, one that is padding
    after slot 1, one of padding only and one of 70,000 slots with
    interior zeros, in buckets of width 2S + 64 and 70,000."""
    g = torch.Generator().manual_seed(seed)
    buckets = []
    for width, lengths in ((2 * S + 64, (S, S + 1, 2 * S, 1, 0)), (70_000, (70_000,))):
        n = len(lengths)
        cols = torch.randint(0, 3000, (n, width), generator=g, dtype=torch.int32)
        w = (torch.rand(n, width, generator=g) + 0.1) / width**0.5
        eidx = torch.randint(0, 5000, (n, width), generator=g, dtype=torch.int32)
        for r, length in enumerate(lengths):
            cols[r, length:], w[r, length:], eidx[r, length:] = 0, 0.0, 0
        w[:, 3:9] = 0.0
        buckets.append(tuple(t.to(dev) for t in (cols, w, eidx)))
    return BucketTable(buckets)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_split_rows_on_the_card(cuda, dtype, masked):
    """Rows split into chunks (second pass) and whole rows around S."""
    table = _split_rows_table(cuda, ell_kernel.SPLIT_SLOTS, 7)
    assert sum(work.splits.shape[0] for _, work in table._tables) == 3  # S + 1, 2S, 70,000
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(3000, 64, device=cuda, generator=g).to(dtype)
    mask = (torch.rand(5000, device=cuda, generator=g) < 0.6).float() / 0.6 if masked else None
    got = gather_reduce(table, x, mask)
    torch.cuda.synchronize()
    _assert_matches_fp32_sum(got, table, x, mask)
    assert torch.equal(got[4], torch.zeros_like(got[4]))  # the row of padding only


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_is_deterministic_on_the_card(cuda, dtype):
    """Two calls on the same inputs are bitwise equal: no atomics, split
    rows' partials are added in chunk order."""
    data = tsyn.powerlaw(6000, 9000, avg_degree=40, seed=4)
    side = tell.ell_from_interactions(data).to(cuda).by_item
    assert sum(work.splits.shape[0] for _, work in side.table._tables) > 0
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(6000, 64, device=cuda, generator=g).to(dtype)
    mask = (torch.rand(data.train_size, device=cuda, generator=g) < 0.5).float() * 2
    first = gather_reduce(side.table, x, mask)
    second = gather_reduce(side.table, x, mask)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _assert_matches_fp32_sum(first, side.table, x, mask)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_side_with_a_row_past_max_width_on_the_card(cuda, dtype):
    """A hub item rated by 70,000 users crosses max_width (65,536): the
    layout cuts it into two rows added back through extra_levels, and the
    kernel splits each of those at S."""
    n, m = 70_000, 40
    rng = np.random.default_rng(0)
    users = np.concatenate([np.arange(n), rng.integers(0, n, 20_000)])
    items = np.concatenate([np.zeros(n, np.int64), rng.integers(1, m, 20_000)])
    pairs = np.unique(np.stack([users, items], 1), axis=0)
    users, items = pairs[:, 0], pairs[:, 1]
    w = tadj.normalized_edge_weights(users, items, np.bincount(users, minlength=n),
                                     np.bincount(items, minlength=m))
    graph = tell.build_ell_graph(users.astype(np.int32), items.astype(np.int32), w, n, m)
    assert graph.by_item.extra_levels
    side = graph.to(cuda).by_item
    x = torch.from_numpy(rng.standard_normal((n, 64)).astype(np.float32) / 4)
    xd = x.to(cuda).to(dtype)
    _assert_matches_fp32_sum(gather_reduce(side.table, xd), side.table, xd, None)
    if dtype == torch.float32:  # the whole side, overflow add included, against the CPU
        got = tell._apply_side(side, xd)
        torch.testing.assert_close(got.cpu(), tell._apply_side(graph.by_item, x),
                                   atol=CARD_ATOL, rtol=0)
