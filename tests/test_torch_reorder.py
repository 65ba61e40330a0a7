"""The port's spectral cluster order against the JAX package's: the same
edges give the identical permutation of both node sides (the tiled
layout and every parity test built on it depend on it)."""

import numpy as np
import pytest

from gsrs_tpu_torch.data import synthetic as tsyn
from gsrs_tpu_torch.ops import reorder as treorder


@pytest.fixture
def jreorder():
    pytest.importorskip("jax", reason="the JAX package is the reference these tests compare with")
    from gsrs_tpu.ops import reorder

    return reorder


def _data(kind, seed):
    if kind == "clustered":
        return tsyn.clustered(64, 96, n_clusters=4, seed=seed)
    return tsyn.powerlaw(200, 300, avg_degree=6, seed=seed)


@pytest.mark.parametrize("kind", ["clustered", "powerlaw"])
@pytest.mark.parametrize("seed", [3, 11])
def test_spectral_order_is_the_jax_order(jreorder, kind, seed):
    d = _data(kind, seed)
    users, items = d.train_users.astype(np.int64), d.train_items.astype(np.int64)
    for n_clusters in (4, 16):
        args = (users, items, d.n_users, d.m_items)
        ours = treorder.spectral_cluster_order(*args, n_clusters=n_clusters, seed=seed)
        theirs = jreorder.spectral_cluster_order(*args, n_clusters=n_clusters, seed=seed)
        for a, b, n in zip(ours, theirs, (d.n_users, d.m_items)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(np.sort(a), np.arange(n))  # a permutation


def test_kmeans_order_is_the_jax_order(jreorder):
    X = np.random.default_rng(0).standard_normal((40_000, 6))  # crosses the 16384-row blocks
    np.testing.assert_array_equal(treorder._kmeans_order(X.copy(), 8, seed=2),
                                  jreorder._kmeans_order(X.copy(), 8, seed=2))
