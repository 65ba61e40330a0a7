"""Normalized bipartite adjacency as padded, pre-sorted edge arrays
(numpy copy of `gsrs_tpu.data.adjacency`).

The graph is one canonical edge list (file order, padding appended) kept
in both sort orders, by user and by item, with the argsort permutations
between them. Padding edges carry weight 0 and endpoints
(n_users-1, m_items-1), so both orders stay sorted. The normalized
weights are cached per dataset directory in ``norm_edges_cache.npz``
with a checksum of the edge list; the cache file is the JAX package's,
so the two packages share it.

Arrays stay numpy on the host. The layouts built from them
(`gsrs_tpu_torch.ops.ell`, ``tiled``, ``hybrid``; `canonical_edges` gives
them the edge list back) are what reaches the device, beside the degree
vectors."""

from __future__ import annotations

import dataclasses
import os
import zipfile
from typing import Optional

import numpy as np

from gsrs_tpu_torch.data.dataset import InteractionData

CACHE_NAME = "norm_edges_cache.npz"


@dataclasses.dataclass(frozen=True)
class BipartiteGraph:
    """Normalized bipartite graph in both sort orders. All edge arrays
    have the same padded length; padding entries carry weight 0."""

    edge_u_by_u: np.ndarray  # (E,) int32 user ids, sorted ascending
    edge_i_by_u: np.ndarray  # (E,) int32 item ids, by-user order
    edge_w_by_u: np.ndarray  # (E,) float32 normalized weights, 0 on pad
    edge_i_by_i: np.ndarray  # (E,) int32 item ids, sorted ascending
    edge_u_by_i: np.ndarray  # (E,) int32 user ids, by-item order
    edge_w_by_i: np.ndarray  # (E,) float32
    perm_by_u: np.ndarray  # (E,) int32: by_u[j] = canonical[perm_by_u[j]]
    perm_by_i: np.ndarray  # (E,) int32
    user_degrees: np.ndarray  # (n,) float32 interaction counts
    item_degrees: np.ndarray  # (m,) float32
    n_users: int
    m_items: int
    n_edges: int


def canonical_edges(graph: BipartiteGraph):
    """(users, items, weights) of the graph's real edges in canonical
    order: the by-user sort inverted through ``perm_by_u``, padding
    dropped; the arrays' own dtypes."""
    sorted_u, sorted_i, sorted_w = graph.edge_u_by_u, graph.edge_i_by_u, graph.edge_w_by_u
    perm = np.asarray(graph.perm_by_u)
    out = []
    for sorted_x in (sorted_u, sorted_i, sorted_w):
        x = np.empty_like(np.asarray(sorted_x))
        x[perm] = sorted_x
        out.append(x[: graph.n_edges])
    return tuple(out)


def normalized_edge_weights(
    users: np.ndarray,
    items: np.ndarray,
    user_degrees: np.ndarray,
    item_degrees: np.ndarray,
) -> np.ndarray:
    """Per-edge ``1/sqrt(d_u · d_i)``, 0 where a degree is 0 (the
    reference's zero-degree convention). Float64 for bit-stable caching;
    cast at the device boundary."""
    du = np.asarray(user_degrees, dtype=np.float64)[users]
    di = np.asarray(item_degrees, dtype=np.float64)[items]
    prod = du * di
    with np.errstate(divide="ignore"):
        w = np.where(prod > 0, 1.0 / np.sqrt(np.maximum(prod, 1e-300)), 0.0)
    return w


def dense_normalized_adjacency(data: InteractionData) -> np.ndarray:
    """Dense (n+m)² float64 ``D^-1/2 [[0, R], [Rᵀ, 0]] D^-1/2``, the
    oracle of the tests (0 where a degree is 0)."""
    n, m = data.n_users, data.m_items
    A = np.zeros((n + m, n + m), dtype=np.float64)
    A[data.train_users, n + data.train_items] = 1.0
    A[n + data.train_items, data.train_users] = 1.0
    d = A.sum(axis=1)
    with np.errstate(divide="ignore"):
        dinv = np.where(d > 0, 1.0 / np.sqrt(np.maximum(d, 1e-300)), 0.0)
    return dinv[:, None] * A * dinv[None, :]


def _edge_checksum(users: np.ndarray, items: np.ndarray) -> np.int64:
    """Content fingerprint of the edge list, so a re-split dataset with
    identical sizes does not reuse stale cached weights."""
    h = np.int64(1469598103934665603)
    mix = (
        users.astype(np.int64) * np.int64(1000003)
        + items.astype(np.int64)
        + np.arange(users.size, dtype=np.int64) * np.int64(31)
    )
    return h ^ np.bitwise_xor.reduce(mix) ^ np.int64(mix.sum())


def save_npz_atomic(path: str, **arrays) -> None:
    """``np.savez`` to ``path`` through a temporary file and a rename, so a
    reader never sees a file half written (the ranks of a mesh build and
    cache the same dataset at once). A read-only directory only loses
    the cache."""
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    except OSError:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load_cached_weights(cache_path: str, data: InteractionData) -> Optional[np.ndarray]:
    """Cached weights when the cache matches ``data``, else None."""
    try:
        with np.load(cache_path) as z:
            if (
                int(z["n_users"]) != data.n_users
                or int(z["m_items"]) != data.m_items
                or z["weights"].shape[0] != data.train_size
                or "checksum" not in z.files
                or int(z["checksum"])
                != int(_edge_checksum(data.train_users, data.train_items))
            ):
                return None
            return z["weights"]
    except (OSError, KeyError, ValueError, zipfile.BadZipFile):
        return None


def build_graph(
    data: InteractionData,
    edge_pad_multiple: int = 8192,
    cache_dir: Optional[str] = None,
) -> BipartiteGraph:
    """Build the padded dual-sorted edge representation from a dataset."""
    users = data.train_users.astype(np.int64)
    items = data.train_items.astype(np.int64)

    w = None
    cache_path = os.path.join(cache_dir, CACHE_NAME) if cache_dir else None
    if cache_path and os.path.exists(cache_path):
        w = _load_cached_weights(cache_path, data)
    if w is None:
        w = normalized_edge_weights(users, items, data.user_degrees, data.item_degrees)
        if cache_path:
            save_npz_atomic(cache_path, weights=w, n_users=data.n_users,
                            m_items=data.m_items, checksum=_edge_checksum(users, items))

    E = users.size
    pad_E = max(edge_pad_multiple, -(-max(E, 1) // edge_pad_multiple) * edge_pad_multiple)
    cu = np.full(pad_E, data.n_users - 1, dtype=np.int32)
    ci = np.full(pad_E, data.m_items - 1, dtype=np.int32)
    cw = np.zeros(pad_E, dtype=np.float32)
    cu[:E] = users
    ci[:E] = items
    cw[:E] = w

    perm_by_u = np.argsort(cu, kind="stable").astype(np.int32)
    perm_by_i = np.argsort(ci, kind="stable").astype(np.int32)
    return BipartiteGraph(
        edge_u_by_u=cu[perm_by_u],
        edge_i_by_u=ci[perm_by_u],
        edge_w_by_u=cw[perm_by_u],
        edge_i_by_i=ci[perm_by_i],
        edge_u_by_i=cu[perm_by_i],
        edge_w_by_i=cw[perm_by_i],
        perm_by_u=perm_by_u,
        perm_by_i=perm_by_i,
        user_degrees=data.user_degrees.astype(np.float32),
        item_degrees=data.item_degrees.astype(np.float32),
        n_users=data.n_users,
        m_items=data.m_items,
        n_edges=int(E),
    )
