"""Interaction datasets (numpy copy of `gsrs_tpu.data.dataset`).

The LightGCN txt format: one line per user, ``uid iid iid …``; blank
lines and lines with a uid but no items are skipped; ``item:timestamp``
tokens are tolerated; node counts are max id + 1 over BOTH train and
test files. A directory may also hold ``train_times.txt``, each train
pair's time in seconds in the same layout (``uid t t …``, line for line
and token for token with train.txt), which the MovieLens converter
writes; `load_dataset` reads it into ``train_times``. Writers of that format, the lastfm loader and the node
padding for a mesh's model axis (`pad_nodes_to_multiple`) are here too."""

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
    counts were padded (None = no padding). ``train_times[k]``: the time
    of pair k in seconds, where the dataset has times (None = none)."""

    name: str
    n_users: int
    m_items: int
    train_users: np.ndarray  # (N,) int64
    train_items: np.ndarray  # (N,) int64
    test_dict: Dict[int, np.ndarray]
    real_m_items: Optional[int] = None
    real_n_users: Optional[int] = None
    train_times: Optional[np.ndarray] = None  # (N,) int64 seconds

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


def write_interaction_file(
    path: str,
    users: np.ndarray,
    items: np.ndarray,
    preserve_order: bool = False,
) -> None:
    """Write (users, items) pairs in the txt format. By default users and
    each user's items are sorted ascending; ``preserve_order=True`` keeps
    users in first-appearance order and items in input order."""
    lines: Dict[int, List[int]] = {}
    order: List[int] = []
    for u, i in zip(users.tolist(), items.tolist()):
        if u not in lines:
            lines[u] = []
            order.append(u)
        lines[u].append(i)
    if not preserve_order:
        order = sorted(order)
    with open(path, "w") as f:
        for u in order:
            its = lines[u] if preserve_order else sorted(lines[u])
            f.write(f"{u} " + " ".join(str(i) for i in its) + "\n")


def write_dataset_dir(out_dir, train_rows, test_rows, train_times=None):
    """A dataset directory from per-user ``(org_user_id, [org_item_id…])``
    rows: train.txt/test.txt with dense remapped ids (item order within a
    row kept), and user_list.txt/item_list.txt mapping ``org_id
    remap_id``; with ``train_times`` (per train row, its items' times in
    seconds) also train_times.txt. → (n_users, m_items)."""
    user_ids = sorted(u for u, _ in train_rows)
    item_ids = sorted({i for _, its in train_rows for i in its}
                      | {i for _, its in test_rows for i in its})
    u_map = {org: k for k, org in enumerate(user_ids)}
    i_map = {org: k for k, org in enumerate(item_ids)}

    os.makedirs(out_dir, exist_ok=True)
    for name, rows in (("train.txt", train_rows), ("test.txt", test_rows)):
        with open(os.path.join(out_dir, name), "w") as f:
            for org_u, its in rows:
                f.write(f"{u_map[org_u]} " + " ".join(str(i_map[i]) for i in its) + "\n")
    if train_times is not None:
        with open(os.path.join(out_dir, "train_times.txt"), "w") as f:
            for (org_u, its), ts in zip(train_rows, train_times, strict=True):
                if len(ts) != len(its):
                    raise ValueError(f"user {org_u}: {len(its)} items, {len(ts)} times")
                f.write(f"{u_map[org_u]} " + " ".join(str(int(t)) for t in ts) + "\n")
    for name, mapping in (("user_list.txt", u_map), ("item_list.txt", i_map)):
        with open(os.path.join(out_dir, name), "w") as f:
            f.write("org_id remap_id\n")
            for org, k in mapping.items():
                f.write(f"{org} {k}\n")
    return len(user_ids), len(item_ids)


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

    times = None
    times_path = os.path.join(dataset_dir, "train_times.txt")
    if os.path.exists(times_path):
        t_u, times = parse_interaction_file(times_path)
        if not np.array_equal(t_u, tr_u):
            raise ValueError(f"{times_path} does not match train.txt pair for pair")
    return InteractionData(
        name=name or (os.path.basename(os.path.normpath(dataset_dir)) or "dataset"),
        n_users=_max(tr_u, te_u) + 1,
        m_items=_max(tr_i, te_i) + 1,
        train_users=tr_u,
        train_items=tr_i,
        test_dict=_build_test_dict(te_u, te_i),
        train_times=times,
    )


def load_lastfm(dataset_dir: str) -> InteractionData:
    """The lastfm format (data1.txt / test1.txt, ``user item weight``
    triples, 1-based ids): ids shift to 0-based, duplicate pairs keep
    their first occurrence."""

    def _parse(path: str) -> Tuple[np.ndarray, np.ndarray]:
        us: List[int] = []
        its: List[int] = []
        seen = set()
        if not os.path.exists(path):
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        with open(path) as f:
            for line in f:
                toks = line.split()
                if len(toks) < 2:
                    continue
                u, i = int(toks[0]) - 1, int(toks[1]) - 1
                if (u, i) in seen:
                    continue
                seen.add((u, i))
                us.append(u)
                its.append(i)
        return np.asarray(us, np.int64), np.asarray(its, np.int64)

    tr_u, tr_i = _parse(os.path.join(dataset_dir, "data1.txt"))
    te_u, te_i = _parse(os.path.join(dataset_dir, "test1.txt"))
    vals_u = [int(a.max()) for a in (tr_u, te_u) if a.size]
    vals_i = [int(a.max()) for a in (tr_i, te_i) if a.size]
    return InteractionData(
        name="lastfm",
        n_users=(max(vals_u) + 1) if vals_u else 0,
        m_items=(max(vals_i) + 1) if vals_i else 0,
        train_users=tr_u,
        train_items=tr_i,
        test_dict=_build_test_dict(te_u, te_i),
    )


def _build_test_dict(users: np.ndarray, items: np.ndarray) -> Dict[int, np.ndarray]:
    test_dict: Dict[int, List[int]] = {}
    for u, i in zip(users.tolist(), items.tolist()):
        test_dict.setdefault(u, []).append(i)
    return {u: np.asarray(v, dtype=np.int64) for u, v in test_dict.items()}


# ------------------------------------------------------------------ padding


def pad_nodes_to_multiple(data: InteractionData, multiple: int) -> InteractionData:
    """Round n_users / m_items up to a multiple so row-sharded embedding
    tables divide evenly across the mesh's model axis. Phantom nodes have
    zero degree and no edges, so they receive no propagation mass; the
    recorded ``real_m_items`` makes bitset consumers reject phantom item
    ids as negatives and mask them out of eval/serving top-k."""
    if multiple <= 1:
        return data
    n = -(-data.n_users // multiple) * multiple
    m = -(-data.m_items // multiple) * multiple
    if n == data.n_users and m == data.m_items:
        return data
    return InteractionData(
        name=data.name,
        n_users=n,
        m_items=m,
        train_users=data.train_users,
        train_items=data.train_items,
        test_dict=data.test_dict,
        real_m_items=data.real_m_items or data.m_items,
        real_n_users=data.real_n_users or data.n_users,
        train_times=data.train_times,
    )
