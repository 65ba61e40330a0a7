"""Vectorized ranking metrics (port of `gsrs_tpu.ops.metrics`).

- ``labels`` r[b, j] = 1 iff the j-th ranked item of user b is a test
  positive;
- recall@k = Σ_{j<k} r / |GT|, precision@k = Σ_{j<k} r / k;
- ndcg@k: DCG = Σ_{j<k} r_j / log2(j+2), IDCG = Σ_{j<min(k,|GT|)} 1/log2(j+2),
  with 0/0 → 0.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from gsrs_tpu_torch.ops.bitset import bitset_lookup


def topk_labels(
    topk_items: torch.Tensor, test_bitset: torch.Tensor, users: torch.Tensor
) -> torch.Tensor:
    """(B, K) float32 hit labels via packed-bitset membership
    (``test_bitset`` is the int32 view of the uint32 words)."""
    return bitset_lookup(test_bitset, users[:, None], topk_items).float()


def recall_precision_at_k(
    labels: torch.Tensor, gt_counts: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-user (recall@k, precision@k)."""
    hits = labels[:, :k].sum(dim=1)
    return hits / torch.clamp(gt_counts, min=1), hits / k


def ndcg_at_k(labels: torch.Tensor, gt_counts: torch.Tensor, k: int) -> torch.Tensor:
    """Per-user NDCG@k with the reference's ideal-DCG convention."""
    j = torch.arange(k, dtype=torch.float32, device=labels.device)
    discounts = 1.0 / torch.log2(j + 2.0)
    dcg = (labels[:, :k] * discounts[None, :]).sum(dim=1)
    ideal_len = torch.clamp(gt_counts, max=k).float()
    idcg = torch.where(j[None, :] < ideal_len[:, None], discounts[None, :], 0.0).sum(dim=1)
    return torch.where(idcg > 0, dcg / torch.clamp(idcg, min=1e-12), 0.0)


def batch_metrics(
    labels: torch.Tensor,
    gt_counts: torch.Tensor,
    user_weights: torch.Tensor,
    topks: Sequence[int],
) -> Dict[str, torch.Tensor]:
    """Summed (not yet averaged) metrics of one user batch, as 0-d
    tensors on the batch's device; padding users carry weight 0."""
    out: Dict[str, torch.Tensor] = {}
    for k in topks:
        rec, prec = recall_precision_at_k(labels, gt_counts, k)
        out[f"recall@{k}"] = (rec * user_weights).sum()
        out[f"precision@{k}"] = (prec * user_weights).sum()
        out[f"ndcg@{k}"] = (ndcg_at_k(labels, gt_counts, k) * user_weights).sum()
    return out


def auc(scores: torch.Tensor, pos_mask: torch.Tensor) -> torch.Tensor:
    """Full-catalog AUC of one user, P(score_pos > score_neg), by the
    rank-sum identity with tie-averaged ranks (ties get half credit).
    scores (m,) float, pos_mask (m,) bool; 0 when either class is empty."""
    m = scores.shape[0]
    order = torch.argsort(scores)
    _, counts = torch.unique_consecutive(scores[order], return_counts=True)
    ends = torch.cumsum(counts, 0).float()  # 1-based rank of each run's last member
    mean_rank_sorted = torch.repeat_interleave(ends - (counts.float() - 1.0) / 2.0, counts)
    ranks = torch.empty(m, dtype=torch.float32, device=scores.device)
    ranks[order] = mean_rank_sorted
    n_pos = pos_mask.sum().float()
    n_neg = m - n_pos
    rank_sum = torch.where(pos_mask, ranks, 0.0).sum()
    value = (rank_sum - n_pos * (n_pos + 1) / 2.0) / torch.clamp(n_pos * n_neg, min=1)
    return torch.where((n_pos > 0) & (n_neg > 0), value, torch.zeros_like(value))
