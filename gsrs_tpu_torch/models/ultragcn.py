"""UltraGCN, propagation-free graph CF (port of `gsrs_tpu.models.ultragcn`).

No message passing in training: the graph enters only through
precomputed constraint weights, so a step is embedding gathers and
dense products. The objective (the paper's eq. 12-17):

- user–item constraint ``L_C``: weighted binary cross-entropy over the
  positive and ``ug_neg_num`` uniform negatives, with weights
  ``w1 + w2·β_ui`` (pos) and ``w3 + w4·β_uj`` (neg), ``β_ui = (√(d_u+1)/d_u)
  · 1/√(d_i+1)``; the negatives' sharing mode ``ug_neg_sharing`` is one of
  ``none`` (per example), ``batch`` (one set), ``group`` (one per row
  group), ``full`` (the closed-form mean over the whole catalog) or
  ``pool`` (per-example Bernoulli subsets of one shared pool);
  ``ug_sift_pos`` drops each user's train positives under ``full`` and
  ``pool``;
- item–item constraint ``L_I`` over each positive's top-K co-occurrence
  neighbours (`build_ii_constraint`), weighted by λ = ``ug_lambda``;
- ``aux["reg"]``: ½‖tables‖², scaled by the trainer's decay.

The loss splits into the draws (`UltraGCN.draw_negatives`, from the step
generator) and `UltraGCN.objective`, which takes them as tensors, so a
test can replay the JAX package's draws. The (B, d)·(d, m) and
(B, d)·(d, P) products are `torch.matmul`, as JAX leaves its ``jnp.dot``
to XLA. Scoring and eval are LightGCN's with zero layers.

The item–item top-K is built on the host, blockwise (G = RᵀR is never
held whole), and cached beside the dataset in the JAX package's file
(``ultragcn_ii_cache.npz``, same keys and checksum), so either package
reads the other's cache.
"""

from __future__ import annotations

import dataclasses
import os
import zipfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gsrs_tpu_torch.data.adjacency import _edge_checksum, save_npz_atomic
from gsrs_tpu_torch.models.lightgcn import LightGCN
from gsrs_tpu_torch.ops.bitset import bitset_lookup, bitset_row_mask

II_CACHE_NAME = "ultragcn_ii_cache.npz"
SHARING = ("none", "batch", "group", "full", "pool")

Draws = Dict[str, torch.Tensor]  # "negs" (none/batch/group) or "pool" + "include" (pool)


def real_edges(graph) -> Tuple[np.ndarray, np.ndarray]:
    """Unpadded (users, items) pairs of the padded edge arrays (padding
    carries weight 0; every real edge has weight > 0)."""
    w = np.asarray(graph.edge_w_by_u)
    mask = w > 0
    return np.asarray(graph.edge_u_by_u)[mask], np.asarray(graph.edge_i_by_u)[mask]


def _load_ii_cache(cache_path: str, k: int, diag_zero: bool, checksum: int, m_items: int):
    """(neighbors, weights) of a matching cache, else None."""
    try:
        with np.load(cache_path) as z:
            if (int(z["k"]) == k and bool(z["diag_zero"]) == diag_zero
                    and int(z["checksum"]) == checksum
                    and z["neighbors"].shape == (m_items, k)):
                return z["neighbors"], z["weights"]
    except (OSError, KeyError, ValueError, zipfile.BadZipFile):
        pass
    return None


def build_ii_constraint(
    graph,
    k: int,
    diag_zero: bool = False,
    block: int = 4096,
    cache_dir: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-K item–item constraint (neighbors (m, K) int32, weights (m, K)
    float32) of the co-occurrence graph G = RᵀR, computed blockwise. Rows
    with fewer than K co-occurring items are padded with weight 0 and the
    item itself. ``diag_zero`` drops G's diagonal."""
    import scipy.sparse as sp

    users, items = real_edges(graph)
    checksum = int(_edge_checksum(users.astype(np.int64), items.astype(np.int64)))
    cache_path = os.path.join(cache_dir, II_CACHE_NAME) if cache_dir else None
    if cache_path and os.path.exists(cache_path):
        cached = _load_ii_cache(cache_path, k, diag_zero, checksum, graph.m_items)
        if cached is not None:
            return cached

    n, m = graph.n_users, graph.m_items
    R = sp.csr_matrix((np.ones(users.size, np.float32), (users, items)), shape=(n, m))
    # g = G·1 = Rᵀ(R·1), without G; diag_zero leaves out G_ii = d_i
    d_u = np.asarray(R.sum(axis=1)).ravel()
    g = np.asarray(R.T @ d_u).ravel()
    if diag_zero:
        g = g - np.asarray(graph.item_degrees, np.float64)[:m]
    with np.errstate(divide="ignore", invalid="ignore"):
        beta_row = np.where(g > 0, np.sqrt(g + 1.0) / np.maximum(g, 1e-12), 0.0)
    beta_col = 1.0 / np.sqrt(g + 1.0)

    RT = R.T.tocsr()  # (m, n)
    neighbors = np.tile(np.arange(m, dtype=np.int32)[:, None], (1, k))
    weights = np.zeros((m, k), dtype=np.float32)
    for i0 in range(0, m, block):
        i1 = min(i0 + block, m)
        nb = i1 - i0
        Gb = (RT[i0:i1] @ R).tocsr()  # (nb, m) slice of G
        counts = np.diff(Gb.indptr)
        rows = np.repeat(np.arange(nb, dtype=np.int64), counts)
        idx, dat = Gb.indices, Gb.data
        if diag_zero:
            dat = np.where(idx == rows + i0, 0.0, dat)
        w = beta_row[i0 + rows] * dat * beta_col[idx]
        if diag_zero:
            # zero-weight entries (the diagonal) are no candidates
            valid = w > 0
            rows, idx, w = rows[valid], idx[valid], w[valid]
            counts = np.bincount(rows, minlength=nb)
        # ragged per-row top-K: sort by (row, -weight), keep each row's first K
        order = np.lexsort((-w, rows))
        rows_s, idx_s, w_s = rows[order], idx[order], w[order]
        row_start = np.concatenate([[0], np.cumsum(counts)])
        within = np.arange(rows_s.size) - np.repeat(row_start[:-1], counts)
        take = within < k
        neighbors[i0 + rows_s[take], within[take]] = idx_s[take]
        weights[i0 + rows_s[take], within[take]] = w_s[take]

    if cache_path:
        save_npz_atomic(cache_path, neighbors=neighbors, weights=weights, k=k,
                        diag_zero=diag_zero, checksum=checksum)
    return neighbors, weights


class UltraGCN(LightGCN):
    """LightGCN's zero-layer scoring surface with UltraGCN's objective.
    ``ii_cache_dir``: where the item–item top-K is cached (the dataset
    directory). ``train_bitset`` (int32 words, the sampler's) is set by
    the Trainer when ``wants_train_bitset``."""

    needs_step_key = True  # the trainer hands a step generator every step
    # epochs visit (user, pos) uniformly over interactions, as the paper
    # iterates its shuffled edge list
    samples_pairs_by_edge = True
    # the negatives are drawn for the whole batch (and shared across it):
    # every data-axis rank takes the whole batch
    batch_separable = False

    def __init__(self, cfg, graph, i2i=None, ell=None, device=None, generator=None,
                 ii_cache_dir: Optional[str] = None):
        if cfg.ug_neg_sharing not in SHARING:
            raise ValueError(f"ug_neg_sharing must be one of {SHARING}, got "
                             f"'{cfg.ug_neg_sharing}'")
        if cfg.ug_neg_sharing == "pool" and cfg.ug_neg_pool < 1:
            raise ValueError("ug_neg_pool must be >= 1")
        if cfg.ug_neg_sharing == "group" and cfg.ug_neg_groups < 1:
            raise ValueError("ug_neg_groups must be >= 1")
        if cfg.ug_sift_pos and cfg.ug_neg_sharing not in ("full", "pool"):
            raise ValueError(
                "ug_sift_pos requires ug_neg_sharing='full' or 'pool' (the other sampled "
                "estimators draw uniformly with collisions, per the paper)")
        cfg = dataclasses.replace(cfg, num_layers=0, dropout=False, use_pop_gate=False,
                                  use_item_item=False)
        super().__init__(cfg, graph, i2i=None, ell=None, device=device, generator=generator)
        self._ii_cache_dir = ii_cache_dir
        self._ii_built = False
        self.ii_neighbors = self.ii_weights = None
        self.wants_train_bitset = cfg.ug_sift_pos
        self.train_bitset: Optional[torch.Tensor] = None
        dev = self.user_emb.device
        du = torch.from_numpy(np.asarray(graph.user_degrees, np.float32)).clamp(min=0.0)
        di = torch.from_numpy(np.asarray(graph.item_degrees, np.float32)).clamp(min=0.0)
        beta_u = torch.where(du > 0, torch.sqrt(du + 1.0) / torch.clamp(du, min=1e-12), 0.0)
        self.register_buffer("beta_u", beta_u.to(dev), persistent=False)
        self.register_buffer("beta_i", (1.0 / torch.sqrt(di + 1.0)).to(dev), persistent=False)

    def _ensure_ii(self) -> None:
        """Build the item–item top-K at the first loss: serving and eval
        build the model only to read its tables and never pay for it."""
        if self._ii_built:
            return
        self._ii_built = True
        cfg = self.cfg
        if cfg.ug_lambda > 0.0 and cfg.ug_ii_k > 0:
            nbrs, w = build_ii_constraint(self.graph, cfg.ug_ii_k, cache_dir=self._ii_cache_dir)
            dev = self.user_emb.device
            self.ii_neighbors = torch.from_numpy(nbrs.astype(np.int64)).to(dev)
            self.ii_weights = torch.from_numpy(w.astype(np.float32)).to(dev)

    @torch.no_grad()
    def init_params(self, generator: Optional[torch.Generator] = None) -> None:
        """N(0, ug_init_std²) tables, drawn on the host from ``generator``."""
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        s = self.cfg.ug_init_std
        self.user_emb.copy_(s * torch.randn(self.user_emb.shape, generator=g))
        self.item_emb.copy_(s * torch.randn(self.item_emb.shape, generator=g))

    # ------------------------------------------------------------------ loss
    def draw_negatives(self, generator: torch.Generator, batch: int) -> Draws:
        """The step's negative draws, made on the generator's device and
        moved to the model's (a host generator gives every device the same
        draws): ``negs`` uniform over the catalog, (B, N) / (N,) / (G, N)
        for none / batch / group; for pool, ``pool`` (P,) and ``include``
        (B, P), each slot in with probability min(N/P, 1); nothing for
        full."""
        cfg, m, dev = self.cfg, self.m_items, generator.device
        N = cfg.ug_neg_num
        mode = cfg.ug_neg_sharing
        if mode == "full":
            return {}
        if mode == "pool":
            P = cfg.ug_neg_pool
            pool = torch.randint(0, m, (P,), generator=generator, device=dev)
            include = torch.rand(batch, P, generator=generator, device=dev) < min(N / P, 1.0)
            draws = {"pool": pool, "include": include}
        else:
            shape = {"none": (batch, N), "batch": (N,), "group": (cfg.ug_neg_groups, N)}[mode]
            draws = {"negs": torch.randint(0, m, shape, generator=generator, device=dev)}
        return {k: v.to(self.user_emb.device) for k, v in draws.items()}

    def _compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.bfloat16) if self.cfg.bf16_compute else x

    def _scores(self, uc: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        """uc (B, d) · items (P, d)ᵀ with fp32 products and sums (JAX's
        ``preferred_element_type=float32``)."""
        return torch.matmul(uc.float(), self._compute(items).float().T)

    def objective(
        self, users: torch.Tensor, pos: torch.Tensor, draws: Draws
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(L_C + λ·L_I, aux) for the batch and the given draws; aux["reg"]
        is ½Σ‖tables‖², aux["bpr"] L_C and aux["ii"] L_I. Sums over the
        batch (the paper's learning rates assume a sum)."""
        self._ensure_ii()
        cfg, m = self.cfg, self.m_items
        beta_u, beta_i = self.beta_u, self.beta_i
        u = self.user_emb[users]
        pe = self.item_emb[pos]
        uc = self._compute(u)
        pos_scores = (uc * self._compute(pe)).sum(dim=1).float()
        w_pos = cfg.ug_w1 + cfg.ug_w2 * beta_u[users] * beta_i[pos]
        pos_loss = w_pos * F.softplus(-pos_scores)  # BCE, label 1

        B, N = users.shape[0], cfg.ug_neg_num
        bu = beta_u[users][:, None]
        neg_denom = None  # default: the mean over the negative axis
        mode = cfg.ug_neg_sharing
        if mode == "full":
            # the estimator's closed-form expectation: the mean over all m items
            neg_scores = self._scores(uc, self.item_emb)  # (B, m)
            w_neg = cfg.ug_w3 + cfg.ug_w4 * (bu * beta_i[None, :])
            if cfg.ug_sift_pos:
                is_pos = bitset_row_mask(self._bitset()[users], m)  # (B, m)
                w_neg = w_neg * (~is_pos).to(w_neg.dtype)
                neg_denom = torch.clamp(m - is_pos.sum(dim=1), min=1).float()
        elif mode == "pool":
            pool, include = draws["pool"], draws["include"]
            neg_scores = self._scores(uc, self.item_emb[pool])  # (B, P)
            w_neg = (cfg.ug_w3 + cfg.ug_w4 * (bu * beta_i[pool][None, :])) * include.float()
            if cfg.ug_sift_pos:
                is_pos = bitset_lookup(self._bitset(), users[:, None], pool[None, :])  # (B, P)
                include = include & ~is_pos
                w_neg = w_neg * (~is_pos).to(w_neg.dtype)
            neg_denom = torch.clamp(include.sum(dim=1), min=1).float()
        elif mode == "batch":
            negs = draws["negs"]
            neg_scores = self._scores(uc, self.item_emb[negs])  # (B, N)
            w_neg = cfg.ug_w3 + cfg.ug_w4 * (bu * beta_i[negs][None, :])
        elif mode == "group":
            negs = draws["negs"]  # (G, N)
            G = negs.shape[0]
            if B % G:
                raise ValueError(f"batch size {B} not divisible by ug_neg_groups {G}")
            ne = self._compute(self.item_emb[negs]).float()  # (G, N, d)
            ug = uc.float().reshape(G, B // G, -1)
            neg_scores = torch.bmm(ug, ne.transpose(1, 2)).reshape(B, N)
            w_neg = cfg.ug_w3 + cfg.ug_w4 * (
                bu * torch.repeat_interleave(beta_i[negs], B // G, dim=0))
        else:
            negs = draws["negs"]  # (B, N)
            ne = self._compute(self.item_emb[negs]).float()  # (B, N, d)
            neg_scores = torch.bmm(ne, uc.float()[:, :, None])[:, :, 0]
            w_neg = cfg.ug_w3 + cfg.ug_w4 * bu * beta_i[negs]
        # BCE, label 0: softplus(s)
        if neg_denom is None:
            neg_loss = (w_neg * F.softplus(neg_scores)).mean(dim=1)
        else:
            neg_loss = (w_neg * F.softplus(neg_scores)).sum(dim=1) / neg_denom
        loss_c = (pos_loss + cfg.ug_neg_weight * neg_loss).sum()

        aux: Dict[str, torch.Tensor] = {"bpr": loss_c}
        loss = loss_c
        if self.ii_neighbors is not None:
            nbrs, wii = self.ii_neighbors[pos], self.ii_weights[pos]  # (B, K)
            nbc = self._compute(self.item_emb[nbrs]).float()  # (B, K, d)
            s = torch.bmm(nbc, uc.float()[:, :, None])[:, :, 0]
            loss_i = (wii * F.softplus(-s)).sum()
            aux["ii"] = loss_i
            loss = loss + cfg.ug_lambda * loss_i
        # γ‖Θ‖²/2 over the full tables, the paper's norm loss
        aux["reg"] = 0.5 * ((self.user_emb ** 2).sum() + (self.item_emb ** 2).sum())
        return loss, aux

    def _bitset(self) -> torch.Tensor:
        if self.train_bitset is None:
            raise ValueError("ug_sift_pos needs the train bitset: the Trainer sets "
                             "model.train_bitset (the sampler's), or set it directly")
        return self.train_bitset

    def bpr_loss(
        self,
        users: torch.Tensor,
        pos: torch.Tensor,
        neg: torch.Tensor,
        dropout_generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The trainer's loss contract: `objective` with this step's draws
        from ``dropout_generator``. The sampler's ``neg`` is not used: the
        paper draws its negatives uniformly, collisions included."""
        if dropout_generator is None:
            raise ValueError("UltraGCN draws its negatives from the step generator; pass "
                             "dropout_generator (the Trainer does via needs_step_key)")
        return self.objective(users, pos, self.draw_negatives(dropout_generator,
                                                               users.shape[0]))
