"""Sequence construction for the sequential family (numpy copy of
`gsrs_tpu.data.sequences`).

Per-user interaction sequences in file order (the temporal order the
converters emit), leave-last-item-out evaluation, and the cluster-Markov
synthetic generator of the learnability checks. Where the dataset has
times, each slot's time in seconds is laid out like the ids (0 at PAD). Item ids are shifted by
+1 inside sequences so that 0 is the padding token; the sequential
trainer unshifts (-1) when it builds catalog bitsets."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from gsrs_tpu_torch.data.dataset import InteractionData


@dataclasses.dataclass
class SequenceData:
    """Leave-last-item-out sequence dataset.

    ``train_seqs[k]``: the history of user ``eval_users[k]`` (shifted ids,
    left-padded with 0, most recent last, held-out target excluded), used
    both for training and as the eval context. ``eval_targets[k]``: the
    held-out (last) item, shifted. ``user_hist_sets[u]``: the unique
    shifted history ids minus the target (a target that also appears
    earlier in the history is not masked away at eval time).
    ``train_times``/``eval_times``: each slot's time in seconds, laid out
    like ``train_seqs``/``eval_seqs`` (0 at PAD); None where the dataset
    has no times."""

    name: str
    n_users: int
    m_items: int
    max_len: int
    train_seqs: np.ndarray  # (N, max_len) int32, shifted, left-padded
    eval_seqs: np.ndarray  # (N, max_len) int32, the eval context
    eval_users: np.ndarray  # (N,) int64
    eval_targets: np.ndarray  # (N,) int32, shifted
    user_hist_sets: Dict[int, np.ndarray]
    train_times: Optional[np.ndarray] = None  # (N, max_len) int64 seconds
    eval_times: Optional[np.ndarray] = None


def sequences_from_interactions(
    data: InteractionData, max_len: int = 50, min_len: int = 2
) -> SequenceData:
    """Leave-last-out sequences from a bipartite dataset, each user's
    train interactions in file order taken as time. Users with fewer than
    ``min_len`` interactions are left out; histories keep the most recent
    ``max_len`` items; each slot's time goes with it where the dataset has
    times."""
    order = np.argsort(data.train_users, kind="stable")
    users_sorted = data.train_users[order]
    items_sorted = data.train_items[order]
    boundaries = np.flatnonzero(np.diff(users_sorted)) + 1
    groups = np.split(items_sorted, boundaries)
    group_users = users_sorted[np.concatenate([[0], boundaries])] if users_sorted.size else []
    with_times = data.train_times is not None
    time_groups = (np.split(np.asarray(data.train_times, np.int64)[order], boundaries)
                   if with_times else [None] * len(groups))

    seqs, times, targets, users, hist_sets = [], [], [], [], {}
    for u, its, ts in zip(np.asarray(group_users, dtype=np.int64), groups, time_groups):
        if its.size < min_len:
            continue
        target = int(its[-1]) + 1
        hist = (its[:-1][-max_len:] + 1).astype(np.int32)
        row = np.zeros(max_len, dtype=np.int32)
        row[max_len - hist.size:] = hist
        seqs.append(row)
        if with_times:
            t_row = np.zeros(max_len, dtype=np.int64)
            t_row[max_len - hist.size:] = ts[:-1][-max_len:]
            times.append(t_row)
        targets.append(target)
        users.append(int(u))
        hist_sets[int(u)] = np.setdiff1d(hist.astype(np.int64), [target])

    train_seqs = np.stack(seqs) if seqs else np.zeros((0, max_len), dtype=np.int32)
    train_times = None
    if with_times:
        train_times = np.stack(times) if times else np.zeros((0, max_len), dtype=np.int64)
    return SequenceData(
        name=data.name,
        n_users=data.n_users,
        m_items=data.m_items,
        max_len=max_len,
        train_seqs=train_seqs,
        eval_seqs=train_seqs,
        eval_users=np.asarray(users, dtype=np.int64),
        eval_targets=np.asarray(targets, dtype=np.int32),
        user_hist_sets=hist_sets,
        train_times=train_times,
        eval_times=train_times,
    )


def synthetic_markov_sequences(
    n_users: int = 600,
    m_items: int = 200,
    n_clusters: int = 5,
    max_len: int = 20,
    seed: int = 0,
    p_stay: float = 0.85,
) -> SequenceData:
    """Cluster-Markov sequences: items fall into contiguous-id clusters; a
    walk stays in its cluster with probability ``p_stay`` (drawing a
    random item there), else jumps to a random cluster. The next item is
    predictable from the last item's cluster."""
    rng = np.random.default_rng(seed)
    cluster_of = (np.arange(m_items) * n_clusters) // m_items
    # a cluster is the contiguous id range [first, first + size): drawing
    # first + integers(0, size) takes from the stream what choice() over
    # its members takes, and gives the same item, at a fraction of the
    # host time
    first = np.searchsorted(cluster_of, np.arange(n_clusters)).tolist()
    size = np.bincount(cluster_of, minlength=n_clusters).tolist()
    integers, uniform = rng.integers, rng.random

    train_seqs = np.zeros((n_users, max_len), dtype=np.int32)
    targets = np.zeros(n_users, dtype=np.int32)
    hist_sets: Dict[int, np.ndarray] = {}
    for u in range(n_users):
        c = int(integers(n_clusters))
        walk = []
        for _ in range(max_len + 1):
            if uniform() >= p_stay:
                c = int(integers(n_clusters))
            walk.append(first[c] + int(integers(0, size[c])) + 1)
        hist = np.asarray(walk[:-1], dtype=np.int32)
        train_seqs[u] = hist
        targets[u] = walk[-1]
        hist_sets[u] = np.setdiff1d(hist.astype(np.int64), [walk[-1]])

    return SequenceData(
        name=f"markov-{n_users}x{m_items}",
        n_users=n_users,
        m_items=m_items,
        max_len=max_len,
        train_seqs=train_seqs,
        eval_seqs=train_seqs,
        eval_users=np.arange(n_users, dtype=np.int64),
        eval_targets=targets,
        user_hist_sets=hist_sets,
    )
