"""Masked full-catalog top-k (port of `gsrs_tpu.ops.topk`): scores are
``U @ I^T``, train positives are pushed to −1e9 through the packed
bitset, and ranking is `torch.topk`. `masked_topk` scores through the
CUDA kernel of `gsrs_tpu_torch.ops.scoring` on a CUDA tensor."""

from __future__ import annotations

from typing import Tuple

import torch

from gsrs_tpu_torch.ops.bitset import bitset_row_mask
from gsrs_tpu_torch.ops.scoring import NEG_INF, masked_scores

__all__ = ["NEG_INF", "score_users", "mask_train_positives", "topk_scores", "masked_topk"]


def score_users(user_emb: torch.Tensor, item_emb: torch.Tensor) -> torch.Tensor:
    """Full-catalog raw dot-product scores U @ I^T (no activation)."""
    return user_emb @ item_emb.T


def mask_train_positives(
    scores: torch.Tensor, train_bitset_rows: torch.Tensor, m_items: int
) -> torch.Tensor:
    return scores.masked_fill(bitset_row_mask(train_bitset_rows, m_items), NEG_INF)


def topk_scores(
    scores: torch.Tensor, k: int, method: str = "exact"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise top-k → (values, indices). Only 'exact' is ported."""
    if method != "exact":
        raise NotImplementedError(
            f"top-k method {method!r} is not ported yet (ROADMAP.md A2c); use 'exact'"
        )
    return torch.topk(scores, k, dim=1)


def masked_topk(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    train_bitset_rows: torch.Tensor,
    k: int,
    method: str = "exact",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (top scores (B, k), top item ids (B, k))."""
    return topk_scores(masked_scores(user_emb, item_emb, train_bitset_rows), k, method)
