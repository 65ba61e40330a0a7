"""Node reordering for block-structured SpMM (port of `gsrs_tpu.ops.reorder`).

After clustering rows by their interaction profile, each cluster's
edges concentrate on a small shared column set, which the tiled layout
(`gsrs_tpu_torch.ops.tiled`) turns into dense per-group hub blocks.

The order is DETERMINISTIC: a truncated SVD of the degree-normalized
adjacency from a fixed start vector, then a seeded k-means over the
leading singular directions, rows ordered by (cluster, -norm). The code
is the JAX package's statement for statement, so the two packages give
the identical order on the same edges (the layout and every parity test
depend on it). Pure numpy/scipy at graph-build time: nothing here runs
on the device.
"""

from __future__ import annotations

import numpy as np


def _kmeans_order(X: np.ndarray, n_clusters: int, seed: int, iters: int = 10):
    """→ order array: order[old_index] = new position. Rows sorted by
    (cluster id, -row norm) so each cluster is contiguous and its
    heaviest rows lead."""
    n = X.shape[0]
    n_clusters = min(n_clusters, n)
    rng = np.random.default_rng(seed)
    cent = X[rng.choice(n, n_clusters, replace=False)]
    lab = np.zeros(n, np.int32)
    for _ in range(iters):
        # blockwise squared distances (keeps memory bounded at scale)
        for s0 in range(0, n, 16384):
            blk = X[s0 : s0 + 16384]
            d2 = ((blk[:, None, :] - cent[None]) ** 2).sum(-1)
            lab[s0 : s0 + 16384] = d2.argmin(1)
        for c in range(n_clusters):
            sel = lab == c
            if sel.any():
                cent[c] = X[sel].mean(0)
    key = lab.astype(np.float64) * 1e9 - (X * X).sum(1)
    order = np.empty(n, np.int64)
    order[np.argsort(key, kind="stable")] = np.arange(n)
    return order


def spectral_cluster_order(
    rows: np.ndarray,
    cols: np.ndarray,
    n: int,
    m: int,
    k: int = 16,
    n_clusters: int = 64,
    seed: int = 0,
):
    """→ (row_order, col_order): deterministic spectral-cluster
    permutations of both node sides (order[old] = new position)."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import svds

    w = np.ones(rows.size, np.float32)
    du = np.bincount(rows, minlength=n).astype(np.float32)
    di = np.bincount(cols, minlength=m).astype(np.float32)
    w /= np.sqrt(np.maximum(du[rows], 1) * np.maximum(di[cols], 1))
    A = sp.coo_matrix((w, (rows, cols)), shape=(n, m)).tocsr()
    k = min(k, min(n, m) - 1)
    # deterministic start vector: svds' default v0 is drawn from global
    # numpy randomness, which would make the order differ across rebuilds
    v0 = np.cos(np.arange(min(n, m), dtype=np.float64))
    u, s, vt = svds(A, k=k, v0=v0)
    return (
        _kmeans_order(u * s, n_clusters, seed),
        _kmeans_order(vt.T * s, n_clusters, seed),
    )
