"""Personalized-PageRank layer weights (port of ``tools/compute_ppr.py``).

    python -m gsrs_tpu_torch.tools.compute_ppr --dataset_dir DS --alpha 0.15 --layers 3 --out ppr.npy

Per node, the PPR mass of each hop k = 0..K (row sums of
alpha (1 - alpha)^k T^k over the row-stochastic transition matrix T of
the bipartite graph), row-normalized into an (N, K + 1) float64 matrix
saved as .npy. It runs on the host in scipy, float64, as the JAX tool
does.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import scipy.sparse as sp


def compute_ppr_weights(adj: sp.csr_matrix, alpha: float, layers: int) -> np.ndarray:
    """(N, layers+1) row-normalized PPR hop-mass weights."""
    deg = np.asarray(adj.sum(axis=1)).ravel()
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1e-300), 0.0)
    T = sp.diags(inv) @ adj  # row-stochastic
    n = adj.shape[0]
    weights = np.zeros((n, layers + 1))
    x = np.ones(n)
    for k in range(layers + 1):
        weights[:, k] = alpha * (1 - alpha) ** k * x
        if k < layers:
            x = T @ x
    rowsum = weights.sum(axis=1, keepdims=True)
    return weights / np.maximum(rowsum, 1e-12)


def main(argv: Optional[list] = None) -> np.ndarray:
    """→ the weights written."""
    ap = argparse.ArgumentParser(prog="gsrs_tpu_torch.tools.compute_ppr")
    ap.add_argument("--dataset_dir", required=True)
    ap.add_argument("--alpha", type=float, default=0.15)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--out", default="ppr_weights.npy")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    from gsrs_tpu_torch.data.dataset import load_dataset

    data = load_dataset(args.dataset_dir)
    n, m = data.n_users, data.m_items
    R = data.user_item_net
    adj = sp.bmat([[None, R], [R.T, None]], format="csr", dtype=np.float64)
    if adj.shape != (n + m, n + m):
        raise ValueError(f"adjacency {adj.shape} for {n} users and {m} items")
    W = compute_ppr_weights(adj, args.alpha, args.layers)
    np.save(args.out, W)
    print(f"wrote {args.out}: shape {W.shape}")
    return W


if __name__ == "__main__":
    main()
