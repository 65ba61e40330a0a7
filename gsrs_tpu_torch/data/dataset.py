"""Interaction datasets (numpy copy of `gsrs_tpu.data.dataset`).

The LightGCN txt format: one line per user, ``uid iid iid …``; blank
lines and lines with a uid but no items are skipped; ``item:timestamp``
tokens are tolerated; node counts are max id + 1 over BOTH train and
test files."""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class InteractionData:
    """A bipartite user-item interaction dataset.

    ``train_users[k]`` interacted with ``train_items[k]``, in file order.
    ``test_dict`` maps user id → int64 array of held-out items.
    ``real_m_items``/``real_n_users`` are the real node counts when the
    counts were padded (None = no padding)."""

    name: str
    n_users: int
    m_items: int
    train_users: np.ndarray  # (N,) int64
    train_items: np.ndarray  # (N,) int64
    test_dict: Dict[int, np.ndarray]
    real_m_items: Optional[int] = None
    real_n_users: Optional[int] = None

    @property
    def train_size(self) -> int:
        return int(self.train_users.size)

    @property
    def user_degrees(self) -> np.ndarray:
        """(n_users,) int64 interaction counts (zero-degree handling lives
        in the normalization, `gsrs_tpu_torch.data.adjacency`)."""
        if not hasattr(self, "_user_degrees"):
            self._user_degrees = np.bincount(self.train_users, minlength=self.n_users)
        return self._user_degrees

    @property
    def item_degrees(self) -> np.ndarray:
        if not hasattr(self, "_item_degrees"):
            self._item_degrees = np.bincount(self.train_items, minlength=self.m_items)
        return self._item_degrees

    @property
    def user_item_net(self) -> sp.csr_matrix:
        """Binary CSR interaction matrix R (users × items)."""
        if not hasattr(self, "_net"):
            net = sp.csr_matrix(
                (
                    np.ones(self.train_size, dtype=np.float32),
                    (self.train_users, self.train_items),
                ),
                shape=(self.n_users, self.m_items),
            )
            net.sum_duplicates()
            net.data[:] = 1.0
            net.sort_indices()
            self._net = net
        return self._net

    def positives_of(self, user: int) -> np.ndarray:
        """Sorted item ids the user interacted with in train."""
        net = self.user_item_net
        return net.indices[net.indptr[user] : net.indptr[user + 1]].astype(np.int64)

    def all_positives(self) -> List[np.ndarray]:
        return [self.positives_of(u) for u in range(self.n_users)]

    def feedback_of(self, users: np.ndarray, items: np.ndarray) -> np.ndarray:
        """uint8 per (user, item) pair: 1 where it is a train interaction."""
        net = self.user_item_net
        return np.asarray(net[np.asarray(users), np.asarray(items)], dtype=np.uint8).ravel()

    def test_users(self) -> np.ndarray:
        """Sorted array of users that have held-out test items."""
        return np.sort(np.fromiter(self.test_dict.keys(), dtype=np.int64))


def parse_interaction_file(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse ``uid iid iid …`` lines → (users, items) int64, file order."""
    users: List[int] = []
    items: List[int] = []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if len(toks) < 2:
                continue
            uid = int(toks[0])
            for tok in toks[1:]:
                items.append(int(tok.split(":", 1)[0]))
                users.append(uid)
    return np.asarray(users, dtype=np.int64), np.asarray(items, dtype=np.int64)


def load_dataset(dataset_dir: str, name: Optional[str] = None) -> InteractionData:
    """Load a train.txt/test.txt dataset directory."""
    tr_u, tr_i = parse_interaction_file(os.path.join(dataset_dir, "train.txt"))
    test_path = os.path.join(dataset_dir, "test.txt")
    if os.path.exists(test_path):
        te_u, te_i = parse_interaction_file(test_path)
    else:
        te_u = te_i = np.zeros(0, dtype=np.int64)

    def _max(*arrays: np.ndarray) -> int:
        vals = [int(a.max()) for a in arrays if a.size]
        return max(vals) if vals else -1

    return InteractionData(
        name=name or (os.path.basename(os.path.normpath(dataset_dir)) or "dataset"),
        n_users=_max(tr_u, te_u) + 1,
        m_items=_max(tr_i, te_i) + 1,
        train_users=tr_u,
        train_items=tr_i,
        test_dict=_build_test_dict(te_u, te_i),
    )


def _build_test_dict(users: np.ndarray, items: np.ndarray) -> Dict[int, np.ndarray]:
    test_dict: Dict[int, List[int]] = {}
    for u, i in zip(users.tolist(), items.tolist()):
        test_dict.setdefault(u, []).append(i)
    return {u: np.asarray(v, dtype=np.int64) for u, v in test_dict.items()}
