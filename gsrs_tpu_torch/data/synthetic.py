"""Synthetic interaction generators (numpy copy of
`gsrs_tpu.data.synthetic`): the same seed gives the same arrays as the
JAX package's generators."""

from __future__ import annotations

from typing import Dict

import numpy as np

from gsrs_tpu_torch.data.dataset import InteractionData


def clustered(
    n_users: int,
    m_items: int,
    n_clusters: int = 4,
    seed: int = 0,
    in_cluster_p: float = 0.25,
    cross_cluster_p: float = 0.005,
) -> InteractionData:
    """Users and items get random cluster labels; in-cluster interactions
    are ~50× likelier than cross-cluster. Every user gets ≥1 train
    positive, and (where possible) one unseen in-cluster item is held out
    per user as the test ground truth."""
    rng = np.random.default_rng(seed)
    uc = rng.integers(0, n_clusters, n_users)
    ic = rng.integers(0, n_clusters, m_items)
    prob = np.where(uc[:, None] == ic[None, :], in_cluster_p, cross_cluster_p)
    mask = rng.random((n_users, m_items)) < prob
    mask[np.arange(n_users), rng.integers(0, m_items, n_users)] = True

    test_dict: Dict[int, np.ndarray] = {}
    for u in range(n_users):
        unseen = np.flatnonzero((~mask[u]) & (ic == uc[u]))
        if unseen.size:
            test_dict[u] = np.array([int(rng.choice(unseen))], dtype=np.int64)

    users, items = np.nonzero(mask)
    return InteractionData(
        name=f"clustered-{n_users}x{m_items}",
        n_users=n_users,
        m_items=m_items,
        train_users=users.astype(np.int64),
        train_items=items.astype(np.int64),
        test_dict=test_dict,
    )


def powerlaw(
    n_users: int,
    m_items: int,
    avg_degree: int = 10,
    seed: int = 0,
    holdout_frac: float = 0.0,
    zipf_s: float = 1.1,
) -> InteractionData:
    """Popularity-skewed dataset: item popularity follows a Zipf law
    (rank^-s), per-user degree is 1 + Poisson(avg_degree - 1), duplicate
    pairs are deduped. With ``holdout_frac`` > 0, that fraction of users
    each move their least popular train item into the test split."""
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, m_items + 1, dtype=np.float64) ** zipf_s
    pop /= pop.sum()
    rank_of = rng.permutation(m_items)
    p_item = pop[rank_of]

    deg = 1 + rng.poisson(max(avg_degree - 1, 0), n_users)
    users = np.repeat(np.arange(n_users, dtype=np.int64), deg)
    items = rng.choice(m_items, size=users.size, p=p_item).astype(np.int64)
    # the (user, item) pairs deduped and sorted as np.unique(..., axis=0)
    # sorts them, through one int64 key: 50x faster at millions of edges
    key = np.unique(users * m_items + items)
    users, items = key // m_items, key % m_items

    test_dict: Dict[int, np.ndarray] = {}
    if holdout_frac > 0:
        counts = np.bincount(users, minlength=n_users)
        eligible = np.flatnonzero(counts >= 2)
        n_test = min(int(round(holdout_frac * n_users)), eligible.size)
        chosen = rng.choice(eligible, size=n_test, replace=False)
        keep = np.ones(users.size, dtype=bool)
        starts = np.concatenate([[0], np.cumsum(counts)])
        for u in chosen:
            s, e = starts[u], starts[u + 1]
            local = np.argmin(p_item[items[s:e]])
            keep[s + local] = False
            test_dict[int(u)] = np.array([int(items[s + local])], dtype=np.int64)
        users, items = users[keep], items[keep]

    return InteractionData(
        name=f"powerlaw-{n_users}x{m_items}",
        n_users=n_users,
        m_items=m_items,
        train_users=users,
        train_items=items,
        test_dict=test_dict,
    )
