"""Plain LightGCN (He et al., SIGIR 2020, arXiv:2002.02126) in float32
PyTorch: the reference that decides ``correct`` in every LightGCN cell.

It works out again, from the raw train pairs, everything the program
derived from them: the normalized adjacency D^-1/2 A D^-1/2 of the
bipartite graph (a zero degree gives weight 0, as the reference code's
``d_inv[isinf] = 0``), the K-layer propagation and the mean over layers
0..K, the BPR loss with the L2 term ``decay · ½(‖u‖² + ‖p‖² + ‖n‖²)/B``
on the propagated rows, Adam (betas 0.9, 0.999, eps 1e-8, bias-corrected),
the train mask, and the full-catalog scores and their top-k. Matrix
products run in float32 with TF32 off.

``dtype`` (None, torch.bfloat16 or torch.float8_e4m3fn) rounds the
tables, every layer's output and every gradient flowing back through
them to that type: the control, the reference in the precision below the
configuration's (fp8 with a per-tensor scale to its largest value, as
fp8 training scales). ``tf32=True`` scores TF32-rounded inputs: the
control of an fp32-with-TF32-off score, the same on every device.

It imports nothing of the program under test.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0
BETAS, EPS = (0.9, 0.999), 1e-8


@contextlib.contextmanager
def matmul_precision(tf32: bool) -> Iterator[None]:
    """Matrix products in TF32 (``tf32``) or in full float32."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _round(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    if dtype is None:
        return x
    if dtype == torch.float8_e4m3fn:
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(dtype).float() * scale
    return x.to(dtype).float()


class _Rounded(torch.autograd.Function):
    """Rounds the value forward and its gradient backward."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return _round(x, dtype)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.dtype), None


def rounded(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return x if dtype is None else _Rounded.apply(x, dtype)


def csr(users: np.ndarray, items: np.ndarray, n_users: int):
    """(indptr, indices) of the pairs by user, items sorted in each row."""
    order = np.lexsort((items, users))
    indptr = np.zeros(n_users + 1, np.int64)
    np.cumsum(np.bincount(users, minlength=n_users), out=indptr[1:])
    return indptr, np.asarray(items)[order].astype(np.int64)


def row_pairs(indptr: np.ndarray, indices: np.ndarray, rows: np.ndarray):
    """(position in ``rows``, item) of every pair of the given rows."""
    start, end = indptr[rows], indptr[rows + 1]
    counts = end - start
    pos = np.repeat(np.arange(rows.size), counts)
    offs = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts)
    return pos, indices[np.repeat(start, counts) + offs]


def norm_adjacency(users: np.ndarray, items: np.ndarray, n_users: int, m_items: int,
                   device) -> torch.Tensor:
    """The symmetric normalized adjacency of the (n + m)-node bipartite
    graph as a coalesced sparse float32 matrix on ``device``."""
    u = torch.as_tensor(np.asarray(users), dtype=torch.int64, device=device)
    i = torch.as_tensor(np.asarray(items), dtype=torch.int64, device=device)
    du = torch.bincount(u, minlength=n_users).double()
    di = torch.bincount(i, minlength=m_items).double()
    w = (1.0 / torch.sqrt(du[u] * di[i])).float()
    idx = torch.stack([torch.cat([u, i + n_users]), torch.cat([i + n_users, u])])
    N = n_users + m_items
    return torch.sparse_coo_tensor(idx, torch.cat([w, w]), (N, N),
                                   check_invariants=False).coalesce()


def propagate(adj: torch.Tensor, emb: torch.Tensor, layers: int,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The mean of layers 0..K of the propagation of ``emb`` ((n + m, d))."""
    x = rounded(emb, dtype)
    acc = x
    for _ in range(layers):
        x = rounded(torch.sparse.mm(adj, x), dtype)
        acc = acc + x
    return acc / (layers + 1)


def bpr_loss(final: torch.Tensor, n_users: int, users, pos, neg, decay: float) -> torch.Tensor:
    u, p, q = final[users], final[n_users + pos], final[n_users + neg]
    bpr = -F.logsigmoid((u * p).sum(1) - (u * q).sum(1)).mean()
    reg = 0.5 * ((u * u).sum() + (p * p).sum() + (q * q).sum()) / users.shape[0]
    return bpr + decay * reg


def leaf_norms(x: torch.Tensor, n_users: int) -> List[float]:
    """Norms of the user rows and the item rows (the two leaves)."""
    return [float(x[:n_users].norm()), float(x[n_users:].norm())]


def train_replay(adj: torch.Tensor, emb0: torch.Tensor, n_users: int, layers: int,
                 batches: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
                 lr: float, decay: float, dtype: Optional[torch.dtype] = None,
                 batch_share: float = 1.0) -> Dict[str, list]:
    """Steps of BPR + Adam from ``emb0`` on the given (users, pos, neg)
    batches → {"loss": each step's loss, "grad": the first gradient's leaf
    norms, "change": the leaf norms of the parameters' change over the
    steps}. ``batch_share`` < 1 takes the loss over that leading share of
    each batch (a planted fault)."""
    p = emb0.detach().clone()
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    out: Dict[str, list] = {"loss": []}
    (b1, b2) = BETAS
    with matmul_precision(False):
        for t, (users, pos, neg) in enumerate(batches, start=1):
            keep = max(1, int(users.shape[0] * batch_share))
            leaf = p.requires_grad_(True)
            loss = bpr_loss(propagate(adj, leaf, layers, dtype), n_users, users[:keep],
                            pos[:keep], neg[:keep], decay)
            (g,) = torch.autograd.grad(loss, leaf)
            out["loss"].append(float(loss.detach()))
            if t == 1:
                out["grad"] = leaf_norms(g, n_users)
            with torch.no_grad():
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                step = (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + EPS)
                p = leaf.detach() - lr * step
    out["change"] = leaf_norms(p - emb0, n_users)
    return out


def final_tables(adj: torch.Tensor, emb: torch.Tensor, n_users: int, layers: int):
    """(users, items) after propagation, float32, no gradient."""
    with torch.no_grad(), matmul_precision(False):
        final = propagate(adj, emb, layers)
    return final[:n_users], final[n_users:]


def tf32_rounded(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits (to nearest, ties
    away from zero), as the tensor cores round a TF32 product's inputs."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def scores(user_rows: torch.Tensor, items: torch.Tensor, users: np.ndarray, train_csr,
           tf32: bool = False) -> torch.Tensor:
    """(B, m) scores of the given users with their train items at -inf;
    ``tf32``: of the inputs rounded to TF32 (the products and sums stay
    float32 on every device)."""
    if tf32:
        user_rows, items = tf32_rounded(user_rows), tf32_rounded(items)
    with matmul_precision(False):
        s = user_rows @ items.T
    pos, it = row_pairs(*train_csr, np.asarray(users))
    dev = s.device
    s[torch.as_tensor(pos, device=dev), torch.as_tensor(it, device=dev)] = float("-inf")
    return s


def rank_gap(exact: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(B,) the widest gap by which the exact score of the item ranked j
    lies below the exact j-th best score, over the ranks j; an id that is
    masked or out of range reads +inf."""
    k = ids.shape[1]
    best = exact.topk(k, dim=1).values
    bad = (ids < 0) | (ids >= exact.shape[1])
    got = exact.gather(1, ids.clamp(0, exact.shape[1] - 1))
    gap = torch.where(bad, torch.full_like(got, float("inf")), best - got)
    return torch.nan_to_num(gap, nan=float("inf"), posinf=float("inf")).amax(dim=1)
