"""The sequential cells' inputs, made from ``--seed``: per-user interaction
sequences at a configuration's published counts (users, items, actions),
and the training sequences cut from them.

The law (a stand-in: the real ratings are not in the repository):

- lengths: ``min_length`` plus a log-normal extra of median 48 (σ 1.38, a
  heavy tail), capped at ``max_length``, scaled to the published action
  count and topped up one action at a time, at random, to exactly that
  count;
- items: each user's drawn without replacement from Zipf popularity
  (weight rank^-s over a random popularity order), by the Gumbel top-n
  trick a chunk of users at a time, so no user repeats an item;
- order: each user's items in a random order, taken as time.

Each user's last item is held out; the training sequence is the last
``max_len`` items before it, ids shifted by +1 (PAD = 0) and left-padded,
the layout of `gsrs_tpu_torch.data.sequences`. As in `benchmark.data`,
the interactions are drawn once from the configuration's
``structure_seed``, and a run's ``--seed`` renumbers the users and items
(`for_config`), so every seed does the same work on other ids.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.data import DATA, RELABEL, torch_seed

LOG_MEDIAN, LOG_SIGMA = float(np.log(48.0)), 1.38
CHUNK_KEYS = 1 << 25  # the Gumbel keys held at once


@dataclasses.dataclass
class Sequences:
    """Each user's training sequence (shifted ids, left-padded) and
    held-out item (shifted), users in one random order."""

    n_users: int
    m_items: int
    max_len: int
    n_actions: int
    train_seqs: np.ndarray  # (n_users, max_len) int64
    targets: np.ndarray  # (n_users,) int64
    lengths: np.ndarray  # (n_users,) int64, each user's actions


def _lengths(n_users, n_actions, min_len, max_len, g, device):
    import torch

    if not n_users * min_len <= n_actions <= n_users * max_len:
        raise ValueError(f"{n_actions} actions do not fit {n_users} users of "
                         f"{min_len}..{max_len}")
    z = torch.randn(n_users, generator=g, device=device, dtype=torch.float64)
    extra = torch.exp(LOG_MEDIAN + LOG_SIGMA * z)
    target = n_actions - min_len * n_users
    room = max_len - min_len
    extra = torch.floor(extra * (target / float(extra.sum()))).clamp_(max=room).long()
    while True:  # top up one action at a time, at random among users with room
        short = target - int(extra.sum())
        if short == 0:
            break
        cand = torch.nonzero(extra < room)[:, 0]
        pick = cand[torch.randperm(cand.numel(), generator=g, device=device)[:short]]
        extra[pick] += 1
    return min_len + extra


def _items(lengths, m_items, zipf_s, g, device):
    """Each user's items, users in order, drawn without replacement by
    Zipf weight (in the order of their Gumbel keys)."""
    import torch

    ranks = torch.randperm(m_items, generator=g, device=device) + 1
    log_w = -zipf_s * torch.log(ranks.float())
    rows = max(1, CHUNK_KEYS // m_items)
    col = torch.arange(m_items, device=device)
    out = []
    for r0 in range(0, lengths.numel(), rows):
        n = lengths[r0:r0 + rows]
        u = torch.rand((n.numel(), m_items), generator=g, device=device)
        keys = log_w - torch.log(-torch.log(u))
        order = torch.argsort(keys, dim=1, descending=True)
        out.append(order[col[None, :] < n[:, None]])
    return torch.cat(out)


def sequences(n_users: int, m_items: int, n_actions: int, max_len: int, min_length: int,
              max_length: int, zipf_s: float, seed: int, device="cpu") -> Sequences:
    """The interactions of the law above from ``seed``, cut into training
    sequences; one seed gives the same sequences on one kind of device."""
    import torch

    g = torch.Generator(device).manual_seed(torch_seed(seed, DATA))
    lengths = _lengths(n_users, n_actions, min_length, min(max_length, m_items), g, device)
    items = _items(lengths, m_items, zipf_s, g, device)
    users = torch.repeat_interleave(torch.arange(n_users, device=device), lengths)
    key = users * 2**31 + torch.randint(0, 2**31, users.shape, generator=g, device=device)
    items = items[torch.argsort(key)]  # a random order within each user: its time
    ends = torch.cumsum(lengths, 0) - 1  # each user's last item, held out
    idx = ends[:, None] - max_len + torch.arange(max_len, device=device)[None, :]
    valid = idx >= (ends - lengths + 1)[:, None]
    seqs = torch.where(valid, items[idx.clamp(min=0)] + 1, 0)
    return Sequences(n_users, m_items, max_len, n_actions, seqs.cpu().numpy(),
                     (items[ends] + 1).cpu().numpy(), lengths.cpu().numpy())


def relabeled(x: Sequences, seed: int, device="cpu") -> Sequences:
    """``x`` with its users reordered and its items renumbered by random
    permutations drawn from the seed."""
    import torch

    g = torch.Generator(device).manual_seed(torch_seed(seed, RELABEL))
    pu = torch.randperm(x.n_users, generator=g, device=device).cpu().numpy()
    shifted = np.concatenate([[0], torch.randperm(x.m_items, generator=g, device=device)
                              .cpu().numpy() + 1])  # PAD stays 0
    return dataclasses.replace(x, train_seqs=shifted[x.train_seqs[pu]],
                               targets=shifted[x.targets[pu]], lengths=x.lengths[pu])


def for_config(cfg: dict, seed: int, device="cpu") -> Sequences:
    """The sequences of configuration ``cfg`` (its ``data`` section): drawn
    from its ``structure_seed``, renumbered from ``seed``."""
    d = cfg["data"]
    x = sequences(d["n_users"], d["m_items"], d["n_actions"], d["max_len"], d["min_length"],
                  d["max_length"], d["zipf_s"], d["structure_seed"], device)
    return relabeled(x, seed, device)
