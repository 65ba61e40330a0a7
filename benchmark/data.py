"""The benchmark's inputs, made from ``--seed``: interactions at a
configuration's published counts, and the embedding tables.

The interaction law is the one `gsrs_tpu_torch/data/synthetic.py::powerlaw`
draws (Zipf item popularity over a random item order, per-user degree
1 + Poisson), copied here so that the yardstick does not move with the
program, and extended in two ways:

- the deduped pairs are topped up and then trimmed to the published
  train + test count exactly, no user losing its last pair;
- the test split is drawn per user at random, as LightGCN's data split
  is: each user holds out its share of the test count (the largest
  remainders rounded up), the pairs chosen at random, and always keeps
  one train pair. A held-out "least popular item" never hits, so every
  eval read 0 on it.

The graph is drawn once from the configuration's ``structure_seed``; a
run's ``--seed`` renumbers its users and items (`for_config`), and draws
the tables, the samples and the requests.

Every array is plain numpy; the harness hands the same arrays to the
program (as an `InteractionData`) and to the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

# the random streams one seed drives, each its own SeedSequence child
DATA, WEIGHTS, REQUESTS, SAMPLE, WARMUP, RELABEL = range(6)


def stream(seed: int, which: int) -> np.random.Generator:
    """The numpy generator of stream ``which`` of ``seed`` (any integer)."""
    return np.random.default_rng(np.random.SeedSequence([seed % 2**63, which]))


def torch_seed(seed: int, which: int) -> int:
    """A torch generator seed for stream ``which`` of ``seed``."""
    return int(np.random.SeedSequence([seed % 2**63, which]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


@dataclasses.dataclass
class Interactions:
    """Train pairs sorted by (user, item), and the test pairs."""

    n_users: int
    m_items: int
    train_users: np.ndarray  # (n_train,) int64
    train_items: np.ndarray  # (n_train,) int64
    test_users: np.ndarray  # (n_test,) int64
    test_items: np.ndarray  # (n_test,) int64

    def test_dict(self) -> Dict[int, np.ndarray]:
        order = np.lexsort((self.test_items, self.test_users))
        u, i = self.test_users[order], self.test_items[order]
        cut = np.flatnonzero(np.diff(u)) + 1
        return {int(us[0]): it for us, it in zip(np.split(u, cut), np.split(i, cut)) if us.size}


def interactions(n_users: int, m_items: int, n_train: int, n_test: int, zipf_s: float,
                 seed: int, device="cpu") -> Interactions:
    """``n_train`` + ``n_test`` distinct (user, item) pairs drawn from the
    seed on ``device``, split per user at random into exactly ``n_test``
    test pairs. One seed gives the same pairs on one kind of device."""
    import torch

    total = n_train + n_test
    if total > n_users * m_items:
        raise ValueError(f"{total} pairs do not fit {n_users} x {m_items}")
    g = torch.Generator(device).manual_seed(torch_seed(seed, DATA))
    f64 = dict(dtype=torch.float64, device=device)

    def rand(n):
        return torch.rand(n, generator=g, **f64)

    pop = 1.0 / torch.arange(1, m_items + 1, **f64) ** zipf_s
    item_cdf = torch.cumsum(pop[torch.randperm(m_items, generator=g, device=device)], 0)
    item_cdf /= item_cdf[-1].clone()
    rate = torch.full((n_users,), max(total / n_users - 1.0, 0.0), **f64)
    deg = 1 + torch.poisson(rate, generator=g).long()
    user_cdf = torch.cumsum(deg.double(), 0)
    user_cdf /= user_cdf[-1].clone()

    def draw_items(n):
        return torch.searchsorted(item_cdf, rand(n)).clamp_(max=m_items - 1)

    users = torch.repeat_interleave(torch.arange(n_users, device=device), deg)
    keys = torch.unique(users * m_items + draw_items(users.numel()))
    while keys.numel() < total:  # dedupe lost pairs: draw more by the same law
        extra = int(1.2 * (total - keys.numel())) + 16
        eu = torch.searchsorted(user_cdf, rand(extra)).clamp_(max=n_users - 1)
        keys = torch.unique(torch.cat([keys, eu * m_items + draw_items(extra)]))
    users, items = keys // m_items, keys % m_items
    rank = _rank_within_user(users, g)
    if keys.numel() > total:  # trim at random, never a user's first pair in random order
        movable = torch.nonzero(rank > 0)[:, 0]
        drop = movable[torch.randperm(movable.numel(), generator=g, device=device)
                       [: keys.numel() - total]]
        keep = torch.ones(keys.numel(), dtype=torch.bool, device=device)
        keep[drop] = False
        users, items = users[keep], items[keep]
        rank = _rank_within_user(users, g)

    d = torch.bincount(users, minlength=n_users)
    share = d.double() * (n_test / total)
    quota = torch.minimum(torch.floor(share).long(), (d - 1).clamp(min=0))
    short = n_test - int(quota.sum())
    if short:  # the largest remainders, ties broken at random, get one more
        frac = share - torch.floor(share) + 1e-9 * rand(n_users)
        quota[torch.topk(torch.where(quota < d - 1, frac, -1.0), short).indices] += 1
    test = rank < quota[users]

    def host(t):
        return t.cpu().numpy()

    return Interactions(n_users, m_items, host(users[~test]), host(items[~test]),
                        host(users[test]), host(items[test]))


def _rank_within_user(users, g):
    """Each pair's rank among its user's pairs in a random order (users
    sorted ascending)."""
    import torch

    key = users * 2**31 + torch.randint(0, 2**31, users.shape, generator=g, device=users.device)
    order = torch.argsort(key)
    starts = torch.searchsorted(users, users[order])
    rank = torch.empty_like(users)
    rank[order] = torch.arange(users.numel(), device=users.device) - starts
    return rank


def relabeled(x: Interactions, seed: int, device="cpu") -> Interactions:
    """``x`` with its users and its items renumbered by random
    permutations drawn from the seed, the train pairs sorted again."""
    import torch

    g = torch.Generator(device).manual_seed(torch_seed(seed, RELABEL))
    pu = torch.randperm(x.n_users, generator=g, device=device).cpu().numpy()
    pi = torch.randperm(x.m_items, generator=g, device=device).cpu().numpy()
    tu, ti = pu[x.train_users], pi[x.train_items]
    order = np.argsort(tu * x.m_items + ti)
    return Interactions(x.n_users, x.m_items, tu[order], ti[order], pu[x.test_users],
                        pi[x.test_items])


def for_config(cfg: dict, seed: int, device="cpu") -> Interactions:
    """The interactions of configuration ``cfg`` (its ``data`` section):
    the graph drawn from the configuration's ``structure_seed``, its users
    and items renumbered from ``seed``. Every seed so gets the same graph
    up to the names of its nodes, and every run the same work (the same
    degrees, so the same layout buckets and launches), on other ids, other
    tables and other samples."""
    d = cfg["data"]
    x = interactions(d["n_users"], d["m_items"], d["n_train"], d["n_test"], d["zipf_s"],
                     d["structure_seed"], device)
    return relabeled(x, seed, device)


def tables(seed: int, n_rows: int, dim: int, device, std: float = 0.1):
    """(n_rows, dim) float32 N(0, std²) rows drawn on ``device`` in one
    call from the seed: the embedding tables (users first, then items)."""
    import torch

    g = torch.Generator(device).manual_seed(torch_seed(seed, WEIGHTS))
    return torch.randn((n_rows, dim), generator=g, device=device, dtype=torch.float32).mul_(std)
