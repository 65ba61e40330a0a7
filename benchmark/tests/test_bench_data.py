"""The generator hits each configuration's published counts exactly and is
a function of the seed."""

import numpy as np
import pytest

from benchmark import data
from benchmark.loops.train import TINY_DATA


def _keys(x):
    return np.concatenate([x.train_users * x.m_items + x.train_items,
                           x.test_users * x.m_items + x.test_items])


@pytest.mark.parametrize("shape", [(300, 500, 6000, 1500), (1000, 700, 20000, 5000)])
def test_exact_counts_distinct_pairs_and_a_train_pair_each(shape):
    n, m, n_train, n_test = shape
    x = data.interactions(n, m, n_train, n_test, 1.1, seed=3)
    assert (x.train_users.size, x.test_users.size) == (n_train, n_test)
    k = _keys(x)
    assert np.unique(k).size == k.size
    assert set(np.unique(x.test_users)) <= set(np.unique(x.train_users))
    assert np.all(np.diff(x.train_users * m + x.train_items) > 0)


def test_deterministic_in_the_seed_and_relabelled_by_it():
    cfg = {"data": dict(TINY_DATA)}
    a, b = data.for_config(cfg, 2**31 + 77), data.for_config(cfg, 2**31 + 77)
    c = data.for_config(cfg, 2**31 + 78)
    assert all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("train_users", "train_items", "test_users", "test_items"))
    assert not np.array_equal(a.train_items, c.train_items)
    # the same graph up to the names of its nodes: the same degrees
    for x, y in ((a.train_users, c.train_users), (a.train_items, c.train_items)):
        assert np.array_equal(np.sort(np.bincount(x)), np.sort(np.bincount(y)))


def test_test_split_is_per_user_and_random():
    x = data.interactions(2000, 3000, 60000, 15000, 1.1, seed=11)
    deg = np.bincount(x.train_users, minlength=2000) + np.bincount(x.test_users, minlength=2000)
    held = np.bincount(x.test_users, minlength=2000)
    share = 15000 / 75000
    assert np.all(np.abs(held - share * deg) < 1.0 + 1e-9)
    # not the least popular item: held-out items are as popular as the rest
    pop = np.bincount(x.train_items, minlength=3000)
    assert pop[x.test_items].mean() > 0.5 * pop[x.train_items].mean()


def test_tables_come_from_the_seed():
    t1, t2 = data.tables(5, 10, 4, "cpu"), data.tables(5, 10, 4, "cpu")
    assert t1.shape == (10, 4) and bool((t1 == t2).all())
    assert not bool((data.tables(6, 10, 4, "cpu") == t1).all())
