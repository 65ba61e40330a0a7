"""The port's device sampler against the contract of tests/test_sampling.py
(the random streams differ from JAX's, so the two packages are held to
the same properties, not the same draws): valid triplets, uniform users
and positives, zero-degree users never drawn, the neg_candidates bias
floor, phantom items, edge-uniform pairs; plus the sampler state and the
numpy fallback, which equal the JAX package's exactly."""

import numpy as np
import pytest
import torch

from gsrs_tpu_torch.data.dataset import InteractionData
from gsrs_tpu_torch.ops.sampling import (
    make_sampler_state,
    sample_epoch,
    sample_pairs_by_edge,
    sample_triplets,
    sample_triplets_python,
)

CPU = "cpu"


def _port(data):
    """The conftest's (JAX package) InteractionData as the port's."""
    return InteractionData(data.name, data.n_users, data.m_items, data.train_users,
                           data.train_items, data.test_dict, data.real_m_items,
                           data.real_n_users)


def _dense(data):
    m = np.zeros((data.n_users, data.m_items), bool)
    m[data.train_users, data.train_items] = True
    return m


def _draw(data, n, seed, **kw):
    state = make_sampler_state(data, CPU)
    g = torch.Generator().manual_seed(seed)
    return [t.numpy() for t in sample_triplets(g, state, n, **kw)]


@pytest.mark.parametrize("neg_candidates", [16, 8])
def test_triplets_are_valid(tiny_data, neg_candidates):
    data = _port(tiny_data)
    users, pos, neg = _draw(data, 4096, 0, neg_candidates=neg_candidates)
    mask = _dense(data)
    assert mask[users, pos].all(), "sampled positive not in the user's positives"
    assert not mask[users, neg].any(), "sampled negative is a train positive"
    assert ((users >= 0) & (users < data.n_users)).all()
    assert ((neg >= 0) & (neg < data.m_items)).all()


@pytest.mark.parametrize("what", ["users", "positives"])
def test_draws_are_uniform(tiny_data, what):
    data = _port(tiny_data)
    users, pos, _ = _draw(data, 60000, 2)
    if what == "users":  # every valid user within 40% of the expected count
        counts = np.bincount(users, minlength=data.n_users)
        valid = data.user_degrees > 0
        expected = users.size / valid.sum()
        assert expected * 0.6 < counts[valid].min() and counts[valid].max() < expected * 1.4
    else:  # the top-degree user's positives: only its own, most of them hit
        u = int(np.argmax(data.user_degrees))
        mine = pos[users == u]
        assert mine.size > 50
        hit, expect = np.unique(mine), data.positives_of(u)
        assert np.isin(hit, expect).all() and hit.size > 0.5 * expect.size


def test_zero_degree_users_never_sampled():
    users = np.array([0, 0, 2, 2, 3], dtype=np.int64)  # user 1 has no positive
    items = np.array([0, 1, 2, 3, 4], dtype=np.int64)
    drawn, _, _ = _draw(InteractionData("z", 4, 5, users, items, {}), 4096, 0)
    assert np.bincount(drawn, minlength=4)[1] == 0


def test_padded_catalog_phantom_items_masked():
    """Item 31 of a catalog padded from 31 to 32 is set in every user's
    bitset row and never drawn as a negative."""
    users = np.repeat(np.arange(10, dtype=np.int64), 5)
    items = np.tile(np.arange(5, dtype=np.int64), 10)
    data = InteractionData("pad", 16, 32, users, items, {}, real_m_items=31, real_n_users=10)
    state = make_sampler_state(data, CPU)
    assert ((state.train_bitset[:, 0] >> 31) & 1).bool().all()
    _, _, neg = _draw(data, 2048, 0)
    assert (neg < 31).all() and (neg >= 5).all()


@pytest.mark.parametrize("c", [2, 4, 8])
def test_neg_candidates_bias_floor(tiny_data, c):
    """The leak rate stays under the documented ρ^C floor (with slack)."""
    data = _port(tiny_data)
    mask = _dense(data)
    rho = mask.sum() / mask.size
    users, pos, neg = _draw(data, 4096, 3, neg_candidates=c)
    assert mask[users, pos].all()
    bound = {2: 3 * rho**2, 4: 3 * rho**4 + 1e-3, 8: 0.0}[c]
    assert mask[users, neg].mean() <= bound


def test_unchecked_mode_leaks_at_the_density(tiny_data):
    data = _port(tiny_data)
    mask = _dense(data)
    rho = mask.sum() / mask.size
    users, pos, neg = _draw(data, 8192, 5, neg_candidates=0)
    assert mask[users, pos].all()
    assert ((neg >= 0) & (neg < data.m_items)).all()
    assert 0.3 * rho < mask[users, neg].mean() < 2.0 * rho


@pytest.mark.parametrize("neg_candidates", [16, 4, 0])
def test_sample_epoch_shapes(tiny_data, neg_candidates):
    data = _port(tiny_data)
    state = make_sampler_state(data, CPU)
    u, p, n = sample_epoch(torch.Generator().manual_seed(4), state, 1000, 250,
                           neg_candidates=neg_candidates)
    assert u.shape == p.shape == n.shape == (4, 250)
    if neg_candidates:
        assert not _dense(data)[u.reshape(-1).numpy(), n.reshape(-1).numpy()].any()
    _, p_e, n_e = sample_epoch(torch.Generator().manual_seed(4), state, 1000, 256, by_edge=True)
    assert p_e.shape == (4, 256) and torch.equal(p_e, n_e)


def test_pairs_by_edge_are_edges_drawn_uniformly(tiny_data):
    data = _port(tiny_data)
    state = make_sampler_state(data, CPU)
    users, pos = (t.numpy() for t in
                  sample_pairs_by_edge(torch.Generator().manual_seed(6), state, 50000))
    assert _dense(data)[users, pos].all()
    # users are drawn in proportion to their degree
    share = np.bincount(users, minlength=data.n_users) / users.size
    want = data.user_degrees / data.train_size
    assert np.abs(share - want).max() < 0.01


def test_sampler_state_matches_jax(tiny_data):
    pytest.importorskip("jax", reason="the JAX package is the reference")
    from gsrs_tpu.ops.sampling import make_sampler_state as jax_state

    t, j = make_sampler_state(_port(tiny_data), CPU), jax_state(tiny_data)
    for name in ("pos_indptr", "pos_items", "valid_users"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    np.testing.assert_array_equal(t.train_bitset.numpy().view(np.uint32),
                                  np.asarray(j.train_bitset))
    assert (t.n_valid, t.m_items) == (j.n_valid, j.m_items)


@pytest.mark.parametrize("full_user", [False, True])
def test_python_fallback_matches_jax(tiny_data, full_user):
    """Same rng, same rows as the JAX package's fallback; a user whose
    positives cover the catalog is skipped."""
    pytest.importorskip("jax", reason="the JAX package is the reference")
    from gsrs_tpu.data.dataset import InteractionData as JaxData
    from gsrs_tpu.ops.sampling import sample_triplets_python as jax_python

    jdata = tiny_data
    if full_user:
        m = 6
        users = np.array([0] * m + [1], dtype=np.int64)
        items = np.array(list(range(m)) + [0], dtype=np.int64)
        jdata = JaxData("full", 2, m, users, items, {})
    rows = sample_triplets_python(np.random.default_rng(0), _port(jdata), 500)
    np.testing.assert_array_equal(rows, jax_python(np.random.default_rng(0), jdata, 500))
    assert rows.ndim == 2 and rows.shape[1] == 3 and rows.size
    mask = _dense(jdata)
    assert mask[rows[:, 0], rows[:, 1]].all() and not mask[rows[:, 0], rows[:, 2]].any()
    if full_user:
        assert (rows[:, 0] == 1).all()
