"""LightGCN as an `nn.Module` (port of `gsrs_tpu.models.lightgcn`).

The module holds the embedding tables (and, with the pop gate, its four
`nn.Linear` layers) as parameters, and the ELL layout of the normalized
bipartite graph on the same device. `propagate` runs K layers and the
mean over layers 0..K; `final_embeddings` adds the pop-gate fusion.

Ported so far: the ELL forward and the pop gate, which is what serving
runs. Other layouts, item-item smoothing, edge dropout and the BPR loss
belong to later slices (ROADMAP.md, queue A) and raise here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from gsrs_tpu_torch.config import ModelConfig
from gsrs_tpu_torch.data.adjacency import BipartiteGraph
from gsrs_tpu_torch.device import DeviceLike, resolve_device
from gsrs_tpu_torch.ops.ell import EllGraph, ell_from_graph, ell_propagate_layer


def popularity_scalar(item_degrees: torch.Tensor) -> torch.Tensor:
    """Standardized log1p(item interaction count), (m,) — the pop-gate
    input feature, with a Bessel-corrected std as in the reference."""
    pop = torch.log1p(torch.clamp(item_degrees.float(), min=0.0))
    mean = pop.mean()
    n = pop.shape[0]
    std = torch.sqrt(((pop - mean) ** 2).sum() / max(n - 1, 1))
    return (pop - mean) / (std + 1e-8)


class LightGCN(nn.Module):
    """LightGCN on ``device`` (default ``cuda:0``). ``ell`` defaults to
    the layout rebuilt from ``graph``; ``generator`` is a CPU
    `torch.Generator` for `init_params` (seed 0 when None)."""

    def __init__(
        self,
        cfg: ModelConfig,
        graph: BipartiteGraph,
        ell: Optional[EllGraph] = None,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if cfg.spmm_mode not in ("ell", "hybrid", "tiled", "segment"):
            raise ValueError(
                f"spmm_mode must be 'ell', 'hybrid', 'tiled' or 'segment', got '{cfg.spmm_mode}'"
            )
        if cfg.spmm_mode != "ell":
            raise NotImplementedError(
                f"spmm_mode='{cfg.spmm_mode}' is not ported yet: 'tiled' comes with the "
                "training slice and 'hybrid'/'segment' with the LightGCN extensions "
                "(ROADMAP.md queue A)"
            )
        if cfg.use_item_item:
            raise NotImplementedError(
                "use_item_item is not ported yet (ROADMAP.md queue A, LightGCN extensions)"
            )
        device = resolve_device(device)
        self.cfg = cfg
        self.n_users = graph.n_users
        self.m_items = graph.m_items
        if ell is None and cfg.num_layers > 0:
            ell = ell_from_graph(graph)
        self.ell = None if ell is None else ell.to(device)
        d = cfg.embedding_dim
        self.user_emb = nn.Parameter(torch.empty(self.n_users, d, device=device))
        self.item_emb = nn.Parameter(torch.empty(self.m_items, d, device=device))
        if cfg.use_pop_gate:
            h, g = cfg.pop_hidden, cfg.gate_hidden
            self.pop_fc1 = nn.Linear(1, h, device=device)
            self.pop_fc2 = nn.Linear(h, d, device=device)
            self.gate_fc1 = nn.Linear(2 * d, g, device=device)
            self.gate_fc2 = nn.Linear(g, 1, device=device)
            pop = popularity_scalar(torch.from_numpy(np.asarray(graph.item_degrees)))
            self.register_buffer("pop_feat", pop[:, None].to(device), persistent=False)
        self.init_params(generator)

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init_params(self, generator: Optional[torch.Generator] = None) -> None:
        """N(0, 0.1²) embeddings; pop-gate layers U(±1/sqrt(fan_in)) for
        weights and biases. Values are drawn on the host from the CPU
        ``generator`` and copied, so a seed gives the same weights on
        every device."""
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.user_emb.copy_(0.1 * torch.randn(self.user_emb.shape, generator=g))
        self.item_emb.copy_(0.1 * torch.randn(self.item_emb.shape, generator=g))
        if self.cfg.use_pop_gate:
            for lin in (self.pop_fc1, self.pop_fc2, self.gate_fc1, self.gate_fc2):
                bound = 1.0 / float(np.sqrt(lin.in_features))
                for p in (lin.weight, lin.bias):
                    p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=g))

    # ----------------------------------------------------------- propagation
    def propagate(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """K-layer propagation + mean over layers 0..K, as fp32. With
        ``bf16_compute`` the layers run in bf16 and only the mean is cast
        back, where the JAX package casts."""
        u, i = self.user_emb, self.item_emb
        if self.cfg.bf16_compute:
            u, i = u.to(torch.bfloat16), i.to(torch.bfloat16)
        acc_u, acc_i = u, i
        cur_u, cur_i = u, i
        for _ in range(self.cfg.num_layers):
            cur_u, cur_i = ell_propagate_layer(self.ell, cur_u, cur_i)
            acc_u = acc_u + cur_u
            acc_i = acc_i + cur_i
        scale = 1.0 / (self.cfg.num_layers + 1)
        return (acc_u * scale).float(), (acc_i * scale).float()

    # ------------------------------------------------------------- pop gate
    def _pop_vec(self) -> torch.Tensor:
        return self.pop_fc2(torch.relu(self.pop_fc1(self.pop_feat)))  # (m, d)

    def _fuse(self, all_items: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        pop_vec = self._pop_vec()
        gate_in = torch.cat([all_items, pop_vec], dim=1)
        logit = self.gate_fc2(torch.relu(self.gate_fc1(gate_in)))  # (m, 1)
        if self.cfg.pop_gate_temp != 1.0:
            logit = logit / self.cfg.pop_gate_temp
        gate = torch.sigmoid(logit)
        return gate * all_items + (1.0 - gate) * pop_vec, gate[:, 0]

    # ------------------------------------------------------------ embeddings
    def final_embeddings(self) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """(all_users, item_embeddings_for_scoring, gates)."""
        all_users, all_items = self.propagate()
        if self.cfg.use_pop_gate:
            items, gate = self._fuse(all_items)
            return all_users, items, gate
        return all_users, all_items, None

    # ----------------------------------------------------------------- heads
    def users_rating(self, users: torch.Tensor) -> torch.Tensor:
        """Full-catalog raw scores for a user batch (no activation)."""
        all_users, items, _ = self.final_embeddings()
        return all_users[users] @ items.T

    def forward(self, users: torch.Tensor, item_ids: torch.Tensor) -> torch.Tensor:
        """Pairwise dot scores."""
        all_users, items, _ = self.final_embeddings()
        return (all_users[users] * items[item_ids]).sum(dim=1)
