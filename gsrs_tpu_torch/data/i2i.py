"""Item-item co-occurrence graph builder, offline (scipy copy of
`gsrs_tpu.data.i2i`).

User (basket) co-occurrence counts, cooc / Jaccard / positive-PMI
weighting, per-item top-k pruning, max-symmetrization and symmetric
``D^-1/2 A D^-1/2`` normalization. The result feeds the model's i2i
smoothing term (`gsrs_tpu_torch.models.lightgcn.ItemItemGraph`).

Run as a CLI:
  python -m gsrs_tpu_torch.data.i2i --dataset_dir data/gowalla \
      --scheme cooc --topk 10 --out data/gowalla/i2i_adj.npz
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from gsrs_tpu_torch.data.dataset import InteractionData


def cooccurrence_counts(data: InteractionData) -> sp.csr_matrix:
    """C[i, j] = number of users holding both i and j; diagonal zeroed."""
    R = data.user_item_net
    C = (R.T @ R).tocsr()
    C.setdiag(0)
    C.eliminate_zeros()
    return C.astype(np.float64)


def weight_matrix(C: sp.csr_matrix, item_degrees: np.ndarray, scheme: str) -> sp.csr_matrix:
    """Reweight co-occurrence counts: ``cooc`` raw counts, ``jaccard``
    c / (d_i + d_j − c), ``ppmi`` max(0, log((c/T) / ((d_i/T)(d_j/T))))
    with T the total interactions (non-positive entries dropped)."""
    if scheme == "cooc":
        return C.copy()
    coo = C.tocoo()
    deg = np.asarray(item_degrees, dtype=np.float64)
    di, dj, c = deg[coo.row], deg[coo.col], coo.data
    if scheme == "jaccard":
        vals = c / np.maximum(di + dj - c, 1e-12)
    elif scheme == "ppmi":
        T = deg.sum()
        with np.errstate(divide="ignore"):
            vals = np.log(np.maximum(c * T / np.maximum(di * dj, 1e-12), 1e-300))
        vals = np.maximum(vals, 0.0)
    else:
        raise ValueError(f"unknown i2i weighting scheme: {scheme!r}")
    out = sp.csr_matrix((vals, (coo.row, coo.col)), shape=C.shape)
    out.eliminate_zeros()
    return out


def topk_prune(A: sp.csr_matrix, k: int) -> sp.csr_matrix:
    """Keep each row's k largest-weight entries."""
    A = A.tocsr()
    keep = np.zeros(A.nnz, dtype=bool)
    for r in range(A.shape[0]):
        s, e = A.indptr[r], A.indptr[r + 1]
        if e - s <= k:
            keep[s:e] = True
        else:
            top = np.argpartition(A.data[s:e], -k)[-k:]
            keep[s + top] = True
    coo = A.tocoo()
    return sp.csr_matrix((coo.data[keep], (coo.row[keep], coo.col[keep])), shape=A.shape)


def symmetrize_and_normalize(A: sp.csr_matrix) -> sp.csr_matrix:
    """max(A, Aᵀ), then D^-1/2 A D^-1/2; zero-degree rows stay zero."""
    M = A.maximum(A.T).tocsr()
    d = np.asarray(M.sum(axis=1)).ravel()
    with np.errstate(divide="ignore"):
        dinv = np.where(d > 0, 1.0 / np.sqrt(np.maximum(d, 1e-300)), 0.0)
    D = sp.diags(dinv)
    return (D @ M @ D).tocsr()


def build_item_item(data: InteractionData, scheme: str = "cooc", topk: int = 10) -> sp.csr_matrix:
    """Counts → weighting → top-k prune → symmetrize + normalize: the
    (m × m) CSR of the i2i smoothing. Degrees for the weighting count each
    (user, item) pair once, as the binary co-occurrence counts do."""
    C = cooccurrence_counts(data)
    binary_deg = np.asarray(data.user_item_net.sum(axis=0)).ravel()
    W = weight_matrix(C, binary_deg, scheme)
    P = topk_prune(W, topk)
    return symmetrize_and_normalize(P)


def main(argv=None) -> None:
    import argparse

    from gsrs_tpu_torch.data.dataset import load_dataset

    ap = argparse.ArgumentParser(prog="gsrs_tpu_torch.data.i2i")
    ap.add_argument("--dataset_dir", required=True)
    ap.add_argument("--scheme", choices=["cooc", "jaccard", "ppmi"], default="cooc")
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    data = load_dataset(args.dataset_dir)
    A = build_item_item(data, scheme=args.scheme, topk=args.topk)
    sp.save_npz(args.out, A)
    print(f"[i2i] wrote {args.out}: {A.shape[0]} items, {A.nnz} edges")


if __name__ == "__main__":
    main()
