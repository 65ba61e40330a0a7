"""LightGCN as an `nn.Module` (port of `gsrs_tpu.models.lightgcn`).

The module holds the embedding tables (and, with the pop gate, its four
`nn.Linear` layers) as parameters, and the layout of the normalized
bipartite graph on the same device: ELL (`gsrs_tpu_torch.ops.ell`) or
tiled (`gsrs_tpu_torch.ops.tiled`, dispatched on the layout's type as in
the JAX package). `propagate` runs K layers and the mean over layers
0..K, with edge dropout when given a generator; `final_embeddings` adds
the pop-gate fusion; `bpr_loss` is the BPR loss with the reference's L2
term (``aux["reg"]``, scaled by the trainer's decay) and the
gate-entropy bonus. Gradients flow through each layout's scatter-free
backward.

With ``use_item_item`` and an `ItemItemGraph`, `propagate` adds
``i2i_alpha · A_i2i @ all_items`` after the fp32 cast of the layer mean;
the product runs through the ELL gather-reduce (`ops.ell.ell_spmm`), its
backward through the transposed side. The hybrid and segment layouts
belong to ROADMAP.md A3 and raise here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gsrs_tpu_torch.config import ModelConfig
from gsrs_tpu_torch.data.adjacency import BipartiteGraph
from gsrs_tpu_torch.device import DeviceLike, resolve_device
from gsrs_tpu_torch.ops.ell import (
    EllGraph, build_ell_graph, ell_from_graph, ell_propagate_layer, ell_spmm,
)
from gsrs_tpu_torch.ops.hashdrop import hashdrop_from_generator
from gsrs_tpu_torch.ops.spmm import edge_keep_mask
from gsrs_tpu_torch.ops.tiled import (
    TiledGraph, tiled_from_graph, tiled_masks, tiled_propagate_layer,
)


@dataclasses.dataclass(frozen=True)
class ItemItemGraph:
    """The normalized item-item adjacency: the JAX package's padded edge
    arrays sorted by destination item (``dst``, ``src``, ``w``; padding
    repeats the last item id with weight 0), and ``ell``, the ELL form of
    its ``n_edges`` real entries (``by_user``: rows ← cols for the
    product, ``by_item``: its transpose for the backward)."""

    dst: torch.Tensor  # (E_pad,) int32, sorted
    src: torch.Tensor  # (E_pad,) int32
    w: torch.Tensor  # (E_pad,) float32, 0 on padding
    m_items: int
    n_edges: int
    ell: EllGraph

    @staticmethod
    def from_scipy(mat, edge_pad_multiple: int = 8192) -> "ItemItemGraph":
        coo = mat.tocoo()
        order = np.argsort(coo.row, kind="stable")
        dst = coo.row[order].astype(np.int32)
        src = coo.col[order].astype(np.int32)
        w = coo.data[order].astype(np.float32)
        pad = -(-max(dst.size, 1) // edge_pad_multiple) * edge_pad_multiple
        last = np.int32(mat.shape[0] - 1)

        def padded(x, fill):
            out = np.full(pad, fill, dtype=x.dtype)
            out[: x.size] = x
            return torch.from_numpy(out)

        m = int(mat.shape[0])
        return ItemItemGraph(
            dst=padded(dst, last), src=padded(src, last), w=padded(w, 0.0),
            m_items=m, n_edges=int(dst.size), ell=build_ell_graph(dst, src, w, m, m),
        )

    def to(self, device) -> "ItemItemGraph":
        return dataclasses.replace(self, dst=self.dst.to(device), src=self.src.to(device),
                                   w=self.w.to(device), ell=self.ell.to(device))


def popularity_scalar(item_degrees: torch.Tensor) -> torch.Tensor:
    """Standardized log1p(item interaction count), (m,) — the pop-gate
    input feature, with a Bessel-corrected std as in the reference."""
    pop = torch.log1p(torch.clamp(item_degrees.float(), min=0.0))
    mean = pop.mean()
    n = pop.shape[0]
    std = torch.sqrt(((pop - mean) ** 2).sum() / max(n - 1, 1))
    return (pop - mean) / (std + 1e-8)


class LightGCN(nn.Module):
    """LightGCN on ``device`` (default ``cuda:0``). ``ell`` (an `EllGraph`
    or a `TiledGraph`) defaults to the layout of ``cfg.spmm_mode`` rebuilt
    from ``graph``; ``i2i`` is used only with ``cfg.use_item_item`` (and
    without it no smoothing runs, as in the JAX package); ``generator``
    is a CPU `torch.Generator` for `init_params` (seed 0 when None)."""

    def __init__(
        self,
        cfg: ModelConfig,
        graph: BipartiteGraph,
        i2i: Optional[ItemItemGraph] = None,
        ell: Union[EllGraph, TiledGraph, None] = None,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if cfg.spmm_mode not in ("ell", "hybrid", "tiled", "segment"):
            raise ValueError(
                f"spmm_mode must be 'ell', 'hybrid', 'tiled' or 'segment', got '{cfg.spmm_mode}'"
            )
        if cfg.spmm_mode not in ("ell", "tiled"):
            raise NotImplementedError(
                f"spmm_mode='{cfg.spmm_mode}' is not ported yet: 'hybrid' and 'segment' are "
                "ROADMAP.md A3 (LightGCN extensions)"
            )
        device = resolve_device(device)
        self.cfg = cfg
        self.graph = graph
        self.n_users = graph.n_users
        self.m_items = graph.m_items
        if ell is None and cfg.num_layers > 0:
            if cfg.spmm_mode == "tiled":
                ell = tiled_from_graph(
                    graph, groups=cfg.tiled_groups, cols=cfg.tiled_cols,
                    dtype=torch.bfloat16 if cfg.bf16_compute else torch.float32,
                )
            else:
                ell = ell_from_graph(graph)
        self.ell = None if ell is None else ell.to(device)
        if i2i is not None and i2i.m_items != self.m_items:
            raise ValueError(f"the i2i graph has {i2i.m_items} items, the model {self.m_items}")
        self.i2i = i2i.to(device) if (cfg.use_item_item and i2i is not None) else None
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
    def propagate(
        self, dropout_generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """K-layer propagation + mean over layers 0..K, as fp32, then the
        i2i smoothing (in fp32) when the model has an i2i graph and
        ``i2i_alpha`` > 0. With ``bf16_compute`` the layers run in bf16
        and only the mean is cast back, where the JAX package casts. With
        ``cfg.dropout`` and a ``dropout_generator`` (on the model's
        device), one edge keep mask is drawn per call and used by every
        layer: in canonical edge order on the ELL layout, the stateless
        hash mask on the tiled one."""
        tiled = isinstance(self.ell, TiledGraph)
        u, i = self.user_emb, self.item_emb
        if self.cfg.bf16_compute:
            u, i = u.to(torch.bfloat16), i.to(torch.bfloat16)
        keep = None
        if dropout_generator is not None and self.cfg.dropout:
            if tiled:
                keep = tiled_masks(self.ell, hashdrop_from_generator(dropout_generator,
                                                                     self.cfg.keep_prob))
            else:
                keep = edge_keep_mask(dropout_generator, self.graph, self.cfg.keep_prob, u.dtype)
        layer = tiled_propagate_layer if tiled else ell_propagate_layer
        acc_u, acc_i = u, i
        cur_u, cur_i = u, i
        for _ in range(self.cfg.num_layers):
            cur_u, cur_i = layer(self.ell, cur_u, cur_i, keep)
            acc_u = acc_u + cur_u
            acc_i = acc_i + cur_i
        scale = 1.0 / (self.cfg.num_layers + 1)
        all_users, all_items = (acc_u * scale).float(), (acc_i * scale).float()
        if self.i2i is not None and self.cfg.i2i_alpha > 0.0:
            all_items = all_items + self.cfg.i2i_alpha * ell_spmm(self.i2i.ell, all_items)
        return all_users, all_items

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
    def final_embeddings(
        self, dropout_generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """(all_users, item_embeddings_for_scoring, gates)."""
        all_users, all_items = self.propagate(dropout_generator)
        if self.cfg.use_pop_gate:
            items, gate = self._fuse(all_items)
            return all_users, items, gate
        return all_users, all_items, None

    # ------------------------------------------------------------------ loss
    def bpr_loss(
        self,
        users: torch.Tensor,
        pos: torch.Tensor,
        neg: torch.Tensor,
        dropout_generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, aux): loss = BPR − gate_entropy_coeff·entropy; aux["reg"]
        is the L2 term the trainer scales by its decay, aux["bpr"] the BPR
        term (and aux["gate_entropy"] with the pop gate)."""
        all_users, items, gate = self.final_embeddings(dropout_generator)
        return self._pairwise_bpr(all_users, items, gate, users, pos, neg)

    def _pairwise_bpr(
        self,
        all_users: torch.Tensor,
        items: torch.Tensor,
        gate: Optional[torch.Tensor],
        users: torch.Tensor,
        pos: torch.Tensor,
        neg: torch.Tensor,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """BPR + reg (+ gate-entropy bonus) on propagated and fused
        embeddings. reg_mode 'ego' regularizes the batch's raw table rows,
        any other value (the default 'propagated') its propagated rows;
        both 0.5·Σ‖·‖²/B."""
        u, pe, ne = all_users[users], items[pos], items[neg]
        pos_scores = (u * pe).sum(dim=1)
        neg_scores = (u * ne).sum(dim=1)
        bpr = -F.logsigmoid(pos_scores - neg_scores).mean()
        batch = users.shape[0]
        if self.cfg.reg_mode == "ego":
            u, pe, ne = self.user_emb[users], self.item_emb[pos], self.item_emb[neg]
        reg = 0.5 * ((u * u).sum() + (pe * pe).sum() + (ne * ne).sum()) / batch
        loss = bpr
        aux = {"bpr": bpr, "reg": reg}
        if gate is not None:
            g = torch.clamp(torch.cat([gate[pos], gate[neg]]), 1e-6, 1.0 - 1e-6)
            entropy = -(g * torch.log(g) + (1 - g) * torch.log(1 - g)).mean()
            loss = loss - self.cfg.gate_entropy_coeff * entropy
            aux["gate_entropy"] = entropy
        return loss, aux

    # ----------------------------------------------------------------- heads
    def users_rating(self, users: torch.Tensor) -> torch.Tensor:
        """Full-catalog raw scores for a user batch (no activation)."""
        all_users, items, _ = self.final_embeddings()
        return all_users[users] @ items.T

    def forward(self, users: torch.Tensor, item_ids: torch.Tensor) -> torch.Tensor:
        """Pairwise dot scores."""
        all_users, items, _ = self.final_embeddings()
        return (all_users[users] * items[item_ids]).sum(dim=1)
