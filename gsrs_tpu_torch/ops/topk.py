"""Masked full-catalog top-k (port of `gsrs_tpu.ops.topk`): scores are
``U @ I^T``, train positives are pushed to −1e9 through the packed
bitset, and `topk_scores` ranks them by one of three methods:

- ``exact``: `exact_topk`, ``lax.top_k``'s values and ids: `torch.topk`
  of k + 1 columns, put in ``lax.top_k``'s order (descending, ties
  lowest column first, +0.0 above −0.0); only rows whose k-th and
  (k + 1)-th values tie are sorted whole;
- ``approx``: the TPU's ``approx_max_k`` (PartialReduce, aggregated to
  top-k): each row folds into L bins, each bin keeps its max, and an
  exact top-k of the bins follows. L and the fold are XLA's
  (`approx_bins`), so the expected recall of the true top-k meets
  ``recall_target``;
- ``threshold``: exact top-k through threshold selection
  (`topk_threshold`): values and ids equal ``lax.top_k``'s.

Every sort that stands in for ``lax.top_k`` (approx's top-k of the bins,
threshold's candidates and its full-row fallbacks, the k columns that
``exact`` keeps, the mesh's merge) ranks by `order_key`: descending in
XLA's total order, −0.0 below +0.0, equal scores lowest column first.

`masked_topk` scores through the CUDA kernel of
`gsrs_tpu_torch.ops.scoring` on a CUDA tensor; the ranking is plain
torch on every device."""

from __future__ import annotations

import math
from typing import Tuple

import torch

from gsrs_tpu_torch.ops.bitset import bitset_row_mask
from gsrs_tpu_torch.ops.scoring import NEG_INF, masked_scores
from gsrs_tpu_torch.utils.timer import span

__all__ = ["NEG_INF", "score_users", "mask_train_positives", "topk_scores", "masked_topk",
           "approx_bins", "topk_approx", "topk_threshold", "stable_topk", "exact_topk",
           "order_key"]

LANE = 128  # XLA's tiling of the reduced dimension (rank > 1)


def score_users(user_emb: torch.Tensor, item_emb: torch.Tensor) -> torch.Tensor:
    """Full-catalog raw dot-product scores U @ I^T (no activation)."""
    return user_emb @ item_emb.T


def mask_train_positives(
    scores: torch.Tensor, train_bitset_rows: torch.Tensor, m_items: int
) -> torch.Tensor:
    return scores.masked_fill(bitset_row_mask(train_bitset_rows, m_items), NEG_INF)


def order_key(scores: torch.Tensor) -> torch.Tensor:
    """Integers in ``lax.top_k``'s order of ``scores``: XLA compares floats
    in their total order, where −0.0 ranks below +0.0 (`torch.sort` holds
    them equal). A float32's bits, its magnitude bits flipped when its
    sign is set, are that order as int32; other float dtypes are compared
    as float32 (which holds every bf16 and fp16 value). Integer scores are
    their own key."""
    if not scores.is_floating_point():
        return scores
    bits = scores.float().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def stable_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise top-k as ``lax.top_k`` orders it: descending in XLA's total
    order, so −0.0 ranks below +0.0, and equal scores lowest column first.
    A stable sort of whole rows on `order_key` (a float sort holds the two
    zeros equal; `torch.topk` promises no order among ties), the values
    gathered."""
    idx = torch.sort(order_key(scores), dim=1, descending=True, stable=True).indices[:, :k]
    return scores.gather(1, idx), idx


def exact_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise top-k with ``lax.top_k``'s values and ids. `torch.topk`
    promises no order among equal scores, so it takes k + 1 columns: a row
    whose k-th value is above its (k + 1)-th has one top-k set, which two
    sorts of its k columns (ids ascending, then values descending, stable)
    put in ``lax.top_k``'s order; a row whose k-th and (k + 1)-th values
    tie (the one case where the set itself depends on the tie order) is
    sorted whole (`stable_topk`). Finding such rows reads one (B,) mask
    on the host. Scores are not NaN."""
    m = scores.shape[1]
    vals, idx = torch.topk(scores, min(k + 1, m), dim=1)
    tied = vals[:, k - 1] == vals[:, k] if k < m else None
    idx, pos = torch.sort(idx[:, :k], dim=1)
    vals, pos = stable_topk(vals.gather(1, pos), k)
    idx = idx.gather(1, pos)
    if tied is not None:
        with span("sync.topk.ties"):
            rows = tied.nonzero().squeeze(1)
        if rows.numel():
            vals[rows], idx[rows] = stable_topk(scores[rows], k)
    return vals, idx


def topk_scores(
    scores: torch.Tensor, k: int, method: str = "exact", recall_target: float = 0.95
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise top-k → (values, indices) by ``method``: "exact",
    "approx" or "threshold" (see the module docstring)."""
    if method == "approx":
        return topk_approx(scores, k, recall_target)
    if method == "threshold":
        return topk_threshold(scores, k)
    if method != "exact":
        raise ValueError(f"top-k method must be 'exact', 'approx' or 'threshold', got {method!r}")
    return exact_topk(scores, k)


# ------------------------------------------------------------------ approx


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def approx_bins(m: int, k: int, recall_target: float) -> Tuple[int, int]:
    """(L, r): the row of m scores folds 2^r times into L bins (L is the
    width of ``approx_max_k(..., aggregate_to_topk=False)``); r = 0 means
    no reduction, an exact top-k. XLA's ``ApproxTopKReductionOutputSize``:
    the recall of K items over M bins is about exp((1 − K)/M), so
    M = (1 − K)/ln(target), at least one lane tile."""
    def width(r):  # ceil(m / 2^r) rounded up to whole lane tiles
        return _ceil_div(_ceil_div(m, 1 << r), LANE) * LANE

    if m <= LANE:
        return m, 0
    tiles = _ceil_div(m, LANE)
    if k == 1:
        r = (tiles - 1).bit_length()  # ceil(log2(tiles))
        return width(r), r
    if recall_target >= 1.0:
        return m, 0
    if not 0.0 < recall_target < 1.0:
        raise ValueError(f"recall_target must lie in (0, 1], got {recall_target}")
    # the target reaches XLA as a float32, widened to double for the log
    target = float(torch.tensor(recall_target, dtype=torch.float32))
    bins = min(max(int((1.0 - k) / math.log(target)), LANE), m)
    r = (m // bins).bit_length() - 1  # floor(log2(m // bins))
    if r == 0:
        return m, 0
    r = min(r, (tiles - 1).bit_length())  # never below one lane tile of bins
    return width(r), r


def topk_approx(
    scores: torch.Tensor, k: int, recall_target: float = 0.95
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.approx_max_k(scores, k, recall_target,
    aggregate_to_topk=True)`` as the TPU computes it: the row, padded
    with −inf to L·2^r columns, folds into L bins (bin j holds columns
    j, j + L, j + 2L, …), each bin keeps its max and the first column
    holding it, and `stable_topk` of the L bins follows. The pad is
    −inf, below the −1e9 of a masked item. r = 0 is `stable_topk`. The
    fold holds −0.0 equal to +0.0 within a bin: which of the two the
    TPU's PartialReduce keeps is not known."""
    B, m = scores.shape
    L, r = approx_bins(m, k, recall_target)
    if r == 0 or k >= L:
        return stable_topk(scores, k)
    folds = 1 << r
    padded = torch.nn.functional.pad(scores, (0, L * folds - m), value=float("-inf"))
    vals, fold = padded.view(B, folds, L).max(dim=1)
    top_vals, bins = stable_topk(vals, k)
    return top_vals, fold.gather(1, bins) * L + bins


# --------------------------------------------------------------- threshold


def _threshold_candidates(scores, t, c, k: int, cap: int):
    """The (up to cap) columns scoring >= t[row], in ascending column
    order, then `stable_topk` of those candidates: exact when c[row] =
    count(score >= t) lies in [k, cap], in ``lax.top_k``'s order. The
    empty slots hold −inf, whose key is below every score's."""
    csum = torch.cumsum(scores >= t[:, None], dim=1, dtype=torch.int32)  # (B, m)
    targets = torch.arange(1, cap + 1, dtype=torch.int32, device=scores.device)
    cols = torch.searchsorted(csum, targets.expand(scores.shape[0], cap).contiguous(),
                              side="left")  # (B, cap) column of the j-th candidate
    valid = targets[None, :] <= c[:, None]
    cols = torch.where(valid, cols, 0)
    cand = torch.where(valid, scores.gather(1, cols), float("-inf"))
    vals, pos = stable_topk(cand, k)
    return vals, cols.gather(1, pos)


def topk_threshold(
    scores: torch.Tensor, k: int, cap: int = 256, max_iters: int = 6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by threshold selection, JAX's `topk_threshold` step for
    step: per-row statistics of the unmasked scores, a Gaussian guess at
    the (k + cap)/2-th largest, up to ``max_iters`` bisection steps for
    rows whose candidate count lies outside [min(k, finite), cap] (rows
    already in the band are frozen, so the fixed count of steps gives
    JAX's while loop's result), then the candidates in column order and a
    small `stable_topk`. One host read per call decides whether every row
    landed in the band; if not, the whole batch takes `stable_topk` of the
    full rows, as JAX's ``lax.cond`` takes ``lax.top_k``. Rows with fewer than
    k unmasked scores fill their last slots with −inf at column 0."""
    B, m = scores.shape
    if k >= m or m <= max(1024, 2 * cap):
        return stable_topk(scores, k)
    cap = min(cap, m)
    floor_t = float(NEG_INF) * 0.5  # above the mask value, below any real score

    finite = scores > floor_t
    x = torch.where(finite, scores, 0.0)
    cnt = finite.sum(dim=1)
    denom = cnt.clamp(min=1).to(scores.dtype)
    mu = x.sum(dim=1) / denom
    var = ((x * x).sum(dim=1) / denom - mu * mu).clamp(min=0.0)
    sigma = torch.sqrt(var) + 1e-20
    rmax = scores.max(dim=1).values

    need = cnt.clamp(max=k)  # rows with < k finite scores need them all
    q = ((k + cap) / 2.0 / denom).clamp(1e-9, 0.5)
    t0 = mu + torch.special.ndtri(1.0 - q) * sigma
    t0 = torch.where(cnt <= cap, torch.full_like(t0, floor_t), torch.minimum(t0, rmax))
    t = t0.clamp(min=floor_t)

    def count_at(t):
        return (scores >= t[:, None]).sum(dim=1)

    lo = torch.full_like(t, floor_t)
    hi = rmax
    ok = torch.zeros(B, dtype=torch.bool, device=scores.device)
    for _ in range(max_iters):
        c = count_at(t)
        ok = ok | ((c >= need) & (c <= cap))
        # too many candidates: raise the threshold; too few: lower it
        lo = torch.where(~ok & (c > cap), t, lo)
        hi = torch.where(~ok & (c < need), t, hi)
        t = torch.where(ok, t, 0.5 * (lo + hi))
    c = count_at(t)
    ok = (c >= need) & (c <= cap)
    all_ok = ok.all()
    with span("sync.topk.threshold"):
        all_ok = bool(all_ok)
    if all_ok:
        return _threshold_candidates(scores, t, c, k, cap)
    return stable_topk(scores, k)


def masked_topk(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    train_bitset_rows: torch.Tensor,
    k: int,
    method: str = "exact",
    recall_target: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (top scores (B, k), top item ids (B, k))."""
    return topk_scores(masked_scores(user_emb, item_emb, train_bitset_rows), k, method,
                       recall_target)
