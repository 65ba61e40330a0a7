"""The port's ELL layout and forward propagation against the JAX
package: identical bucket arrays (including split mega rows) and the
same layer output at fp32, where only the order of summation differs."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="the JAX package is the reference these tests compare with")

import jax.numpy as jnp

from gsrs_tpu.data import adjacency as jadj
from gsrs_tpu.data import synthetic as jsyn
from gsrs_tpu.ops import ell as jell
from gsrs_tpu_torch.data import adjacency as tadj
from gsrs_tpu_torch.data import synthetic as tsyn
from gsrs_tpu_torch.ops import ell as tell

RTOL, ATOL = 1e-5, 1e-6  # fp32, summation order only


def _chunk_pairs(side):
    """The side's overflow-chunk (dst, pos) pairs, sorted: the port keeps
    them by chunk level (``extra_levels``), JAX by row
    (``extra_dst``/``extra_pos``, None when no row was split)."""
    if hasattr(side, "extra_levels"):
        pairs = [(int(a), int(b)) for d, p in side.extra_levels for a, b in zip(d, p)]
    elif side.extra_dst is None:
        pairs = []
    else:
        pairs = list(zip(np.asarray(side.extra_dst).tolist(), np.asarray(side.extra_pos).tolist()))
    return np.asarray(sorted(pairs), dtype=np.int64).reshape(-1, 2)


def _assert_same_side(t, j):
    assert t.n_rows == j.n_rows and len(t.buckets) == len(j.buckets)
    for tb, jb in zip(t.buckets, j.buckets):
        for name in ("rows", "cols", "w", "eidx"):
            np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                          np.asarray(getattr(jb, name)), err_msg=name)
    np.testing.assert_array_equal(t.assemble.numpy(), np.asarray(j.assemble))
    np.testing.assert_array_equal(_chunk_pairs(t), _chunk_pairs(j))


def _assert_same_graph(t, j):
    assert (t.n_users, t.m_items) == (j.n_users, j.m_items)
    _assert_same_side(t.by_user, j.by_user)
    _assert_same_side(t.by_item, j.by_item)


def _hub_graph(max_width):
    """powerlaw(200, 300) plus one item every user interacted with, so
    that item's row is wider than ``max_width`` and gets split."""
    d = tsyn.powerlaw(200, 300, seed=5)
    pairs = np.unique(np.concatenate([
        np.stack([d.train_users, d.train_items], 1),
        np.stack([np.arange(200), np.full(200, 17)], 1),
    ]), axis=0)
    users, items = pairs[:, 0], pairs[:, 1]
    du, di = np.bincount(users, minlength=200), np.bincount(items, minlength=300)
    w = tadj.normalized_edge_weights(users, items, du, di)
    args = (users.astype(np.int32), items.astype(np.int32), w, 200, 300, 4, max_width)
    return tell.build_ell_graph(*args), jell.build_ell_graph(*args)


def test_ell_from_interactions_matches_jax():
    _assert_same_graph(tell.ell_from_interactions(tsyn.powerlaw(200, 300, seed=1)),
                       jell.ell_from_interactions(jsyn.powerlaw(200, 300, seed=1)))


def test_ell_from_graph_matches_jax():
    t = tell.ell_from_graph(tadj.build_graph(tsyn.powerlaw(80, 120, seed=2), 256))
    j = jell.ell_from_graph(jadj.build_graph(jsyn.powerlaw(80, 120, seed=2), 256))
    _assert_same_graph(t, j)


@pytest.mark.parametrize("max_width", [8, 48])  # 48 rounds down to 32
def test_mega_row_split_matches_jax(max_width):
    t, j = _hub_graph(max_width)
    assert t.by_item.extra_levels
    _assert_same_graph(t, j)


def _layer_inputs(n, m, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((m, d)).astype(np.float32))


@pytest.mark.parametrize("case", ["powerlaw", "mega_rows"])
def test_ell_propagate_layer_matches_jax(case):
    if case == "powerlaw":
        t = tell.ell_from_interactions(tsyn.powerlaw(200, 300, seed=1))
        j = jell.ell_from_interactions(jsyn.powerlaw(200, 300, seed=1))
    else:
        t, j = _hub_graph(8)
    u, i = _layer_inputs(200, 300)
    tu, ti = tell.ell_propagate_layer(t, torch.from_numpy(u), torch.from_numpy(i))
    ju, ji = jell.ell_propagate_layer(j, jnp.asarray(u), jnp.asarray(i))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL, atol=ATOL)


def test_ell_graph_to_moves_every_tensor():
    t, _ = _hub_graph(8)
    moved = t.to("meta")
    assert all(t.device.type == "meta" for lv in moved.by_item.extra_levels for t in lv)
    assert moved.by_item.extra_levels
    assert all(b.cols.device.type == "meta" for b in moved.by_user.buckets)
    assert moved.by_user.assemble.device.type == "meta"
