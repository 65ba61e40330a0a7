"""Full-catalog top-k evaluation (port of `gsrs_tpu.train.evaluator`).

One propagation per `run`, then the test users in padded batches of
``test_batch``: gather the batch's user rows, score the whole catalog
with the train positives masked by the CUDA kernel of
`gsrs_tpu_torch.ops.scoring` (K1, or K2 in the bit-plane branch), take
the top ``max(topks)`` by ``topk_method`` (`gsrs_tpu_torch.ops.topk`:
exact, approx or threshold; in the bit-plane branch on the permuted
columns, then mapped back), and sum recall, precision and NDCG on the
device. The padded tail carries user weight 0. The host reads the sums
once, at the end of `run`, and the top-k reads one mask a batch (exact:
which rows tie at the k-th value; threshold: whether every row landed).
Spans (`gsrs_tpu_torch.utils.timer.span`, recorded under a profile):
``eval.run``, ``eval.propagate``, and per batch ``eval.batch`` holding
``eval.score`` (K1), ``eval.topk`` and ``eval.metrics``; ``sync.eval.read``
around the read of the sums.

On a mesh (``mesh``, as the Trainer passes it) the propagation runs on
the gathered tables and the rank's ELL shard; each rank scores its data
slice of every batch over its catalog shard and the model axis merges
the top-k (`gsrs_tpu_torch.parallel.dist_train.sharded_topk`); the metric
sums are summed over the data axis. Phantom users (a padded dataset's)
hold no test item, so they count for nothing.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gsrs_tpu_torch.config import EvalConfig
from gsrs_tpu_torch.data.dataset import InteractionData
from gsrs_tpu_torch.device import DeviceLike, resolve_device
from gsrs_tpu_torch.ops.bitset import bitset_columns, bitset_to_tensor, build_bitset
from gsrs_tpu_torch.ops.metrics import batch_metrics, topk_labels
from gsrs_tpu_torch.ops.scoring import (
    bitplane_permutation,
    masked_scores,
    resolve_bitplane_scoring,
)
from gsrs_tpu_torch.ops.topk import topk_scores
from gsrs_tpu_torch.utils.timer import span

BITPLANE_BLOCK_M = 4096


class Evaluator:
    """Evaluates ``model`` (a LightGCN on ``device``, default ``cuda:0``)
    on ``data.test_dict``. ``train_bitset``: the (n_users, W) int32 train
    bitset already on the device (the sampler's), so that no second copy
    is held; built from ``data`` when None."""

    def __init__(
        self,
        data: InteractionData,
        model,
        cfg: EvalConfig,
        train_bitset: Optional[torch.Tensor] = None,
        device: DeviceLike = None,
        mesh=None,
    ):
        self.device = resolve_device(device)
        self.mesh = mesh
        if model.user_emb.device != self.device:
            raise ValueError(f"the model is on {model.user_emb.device}, the Evaluator on "
                             f"{self.device}")
        if cfg.topk_method not in ("exact", "approx", "threshold"):
            raise ValueError(f"topk_method must be 'exact', 'approx' or 'threshold', got "
                             f"{cfg.topk_method!r}")
        self.cfg = cfg
        self.model = model
        self.max_k = max(cfg.topks)

        test_users = data.test_users()
        self.n_test_users = int(test_users.size)
        B = cfg.test_batch
        n_batches = max(1, -(-self.n_test_users // B))
        users = np.zeros(n_batches * B, dtype=np.int64)
        users[: self.n_test_users] = test_users
        weights = np.zeros(n_batches * B, dtype=np.float32)
        weights[: self.n_test_users] = 1.0
        gt = np.zeros(data.n_users, dtype=np.float32)
        for u, items in data.test_dict.items():
            gt[u] = len(items)
        dev = self.device
        self._users = torch.from_numpy(users.reshape(n_batches, B)).to(dev)
        self._weights = torch.from_numpy(weights.reshape(n_batches, B)).to(dev)
        self._gt = torch.from_numpy(gt[users].reshape(n_batches, B)).to(dev)

        if train_bitset is None:
            train_bitset = build_bitset(data.train_users, data.train_items, data.n_users,
                                        data.m_items, real_m_items=data.real_m_items)
        self.train_bitset = bitset_to_tensor(train_bitset, dev)
        if data.test_dict:
            te_u = np.concatenate([np.full(len(v), k, np.int64) for k, v in data.test_dict.items()])
            te_i = np.concatenate([np.asarray(v) for v in data.test_dict.values()])
        else:
            te_u = te_i = np.zeros(0, np.int64)
        self.test_bitset = bitset_to_tensor(build_bitset(te_u, te_i, data.n_users, data.m_items),
                                            dev)

        self._m = data.m_items
        self._bitplane = (resolve_bitplane_scoring(cfg.use_pallas_scoring, data.m_items)
                          and cfg.pallas_variant == "bitplane")
        if mesh is not None:
            from gsrs_tpu_torch.parallel.sharding import GraphShardings, catalog_range

            if self._bitplane:
                raise ValueError("the bit-plane scoring layout is not used on a mesh (as in the "
                                 "JAX package): use_pallas_scoring 'auto' or 'off'")
            self._sh = GraphShardings(mesh)
            self._part = self._sh.batch_spec(B)
            self._lo, self._hi = catalog_range(data.m_items, mesh)
            self._shard_bitset = bitset_columns(self.train_bitset, self._lo, self._hi)
        if self._bitplane:
            m, block_m = self._m, BITPLANE_BLOCK_M
            self._m_pad = -(-m // block_m) * block_m
            self._bp_perm = torch.from_numpy(bitplane_permutation(self._m_pad, block_m)).to(dev)
            # the batch's bitset rows widen to m_pad/32 words: pad words all
            # ones, and the ragged bits [m, 32·W) of the last natural word
            # set, so every phantom column is masked
            W = self.train_bitset.shape[1]
            self._pad_words = torch.full((B, self._m_pad // 32 - W), -1, dtype=torch.int32,
                                         device=dev)
            self._ragged = None
            if m % 32:
                high = np.array([0xFFFFFFFF << (m % 32) & 0xFFFFFFFF], np.uint32)
                self._ragged = int(high.view(np.int32)[0])

    def _topk(self, scores: torch.Tensor) -> torch.Tensor:
        with span("eval.topk"):
            return topk_scores(scores, self.max_k, self.cfg.topk_method,
                               self.cfg.topk_recall_target)[1]

    def _top_items(self, u_emb: torch.Tensor, items: torch.Tensor, rows: torch.Tensor):
        """→ (top item ids (B, max_k), valid (B, max_k) float or None)."""
        if not self._bitplane:
            with span("eval.score"):
                scores = masked_scores(u_emb, items, rows)
            return self._topk(scores), None
        with span("eval.score"):
            if self._ragged is not None:
                rows[:, -1] |= self._ragged
            rows = torch.cat([rows, self._pad_words], dim=1)
            scores = masked_scores(u_emb, items, rows, bitplane=True, block_m=BITPLANE_BLOCK_M)
        top = self._bp_perm[self._topk(scores)]
        # phantom columns surface only for users whose whole row ties at
        # the mask value; their labels are zeroed and the ids clamped
        valid = (top < self._m).float()
        return top.clamp_(max=self._m - 1), valid

    def _batches(self):
        """One propagation, then per padded batch (users, weights, gt,
        top item ids, valid or None); on a mesh, of this rank's data
        slice of each batch."""
        if self.mesh is not None:
            yield from self._mesh_batches()
            return
        with span("eval.propagate"):
            all_users, items, _ = self.model.final_embeddings()
            if self._bitplane:
                items = F.pad(items, (0, 0, 0, self._m_pad - self._m))[self._bp_perm].contiguous()
        for users, weights, gt in zip(self._users, self._weights, self._gt):
            # open until the consumer asks for the next batch: its metrics
            # are the batch's too
            with span("eval.batch"):
                u_emb = all_users.index_select(0, users)
                rows = self.train_bitset.index_select(0, users)
                yield (users, weights, gt) + self._top_items(u_emb, items, rows)

    def _mesh_batches(self):
        from gsrs_tpu_torch.parallel.dist_train import sharded_topk

        all_users, items, _ = self._sh.call(self.model, "final_embeddings")
        shard = items[self._lo:self._hi].contiguous()
        for users, weights, gt in zip(self._users, self._weights, self._gt):
            users, weights, gt = users[self._part], weights[self._part], gt[self._part]
            _, top = sharded_topk(all_users.index_select(0, users), shard,
                                  self._shard_bitset.index_select(0, users), self.max_k,
                                  self.mesh, self._lo, self._m, self.cfg.topk_method,
                                  self.cfg.topk_recall_target)
            yield users, weights, gt, top, None

    @torch.no_grad()
    def top_items(self) -> torch.Tensor:
        """(n_test_users, max(topks)) top item ids of the test users, in
        `InteractionData.test_users` order, by ``topk_method``."""
        tops = torch.stack([top for _, _, _, top, _ in self._batches()])
        if self.mesh is not None:
            from gsrs_tpu_torch.parallel.collectives import all_gather

            # (D · n_batches, B/D, k): data rank d's slices, then the next rank's
            tops = all_gather(tops, self.mesh, "data").view(self.mesh.data_size, *tops.shape)
            tops = tops.transpose(0, 1)
        return tops.reshape(-1, tops.shape[-1])[: self.n_test_users]

    @torch.no_grad()
    def run(self) -> Dict[str, float]:
        """One propagation of the model's current parameters + every
        scoring batch → mean metrics over the real test users."""
        totals: Dict[str, torch.Tensor] = {}
        with span("eval.run"):
            for users, weights, gt, top, valid in self._batches():
                with span("eval.metrics"):
                    labels = topk_labels(top, self.test_bitset, users)
                    if valid is not None:
                        labels = labels * valid
                    for k, v in batch_metrics(labels, gt, weights, self.cfg.topks).items():
                        totals[k] = totals[k] + v if k in totals else v
            names = list(totals)
            values = torch.stack([totals[k] for k in names])
            if self.mesh is not None:
                from gsrs_tpu_torch.parallel.collectives import all_reduce_

                all_reduce_(values, self.mesh, "data")
            with span("sync.eval.read"):
                values = values.cpu()
        values = values.tolist()
        denom = max(self.n_test_users, 1)
        return {k: v / denom for k, v in zip(names, values)}
