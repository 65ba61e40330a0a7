"""LightGCN as an `nn.Module` (port of `gsrs_tpu.models.lightgcn`).

The module holds the embedding tables (and, with the pop gate, its four
`nn.Linear` layers) as parameters, and the layout of the normalized
bipartite graph on the same device, dispatched on the layout's type as in
the JAX package: ELL (`gsrs_tpu_torch.ops.ell`, which the segment layout
also runs: `gsrs_tpu_torch.ops.spmm`), tiled (`gsrs_tpu_torch.ops.tiled`)
or hybrid (`gsrs_tpu_torch.ops.hybrid`). `propagate` runs K
layers and the mean over layers 0..K, with edge dropout when given a
generator; `final_embeddings` adds the pop-gate fusion; `bpr_loss` is the
BPR loss with the reference's L2 term (``aux["reg"]``, scaled by the
trainer's decay) and the gate-entropy bonus. Gradients flow through each
layout's scatter-free backward.

With ``use_item_item`` and an `ItemItemGraph`, `propagate` adds
``i2i_alpha · A_i2i @ all_items`` after the fp32 cast of the layer mean;
the product runs through the ELL gather-reduce (`ops.ell.ell_spmm`), its
backward through the transposed side.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

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
from gsrs_tpu_torch.ops.gather import gather_rows, gather_rows_cat
from gsrs_tpu_torch.ops.hashdrop import hashdrop_from_generator
from gsrs_tpu_torch.ops.hybrid import (
    HybridGraph, hybrid_from_graph, hybrid_masks, hybrid_propagate_layer,
)
from gsrs_tpu_torch.ops.spmm import edge_keep_mask
from gsrs_tpu_torch.ops.tiled import (
    TiledGraph, tiled_from_graph, tiled_masks, tiled_propagate_layer,
)
from gsrs_tpu_torch.utils.timer import span

Layout = Union[EllGraph, TiledGraph, HybridGraph]
Layer = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


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


def default_layout(cfg: ModelConfig, graph: BipartiteGraph) -> Layout:
    """The layout of ``cfg.spmm_mode`` built from ``graph``'s padded edge
    arrays, dense blocks in the compute dtype (the JAX package's
    defaults). The segment layout is the ELL layout (`ops.spmm`)."""
    dtype = torch.bfloat16 if cfg.bf16_compute else torch.float32
    if cfg.spmm_mode == "tiled":
        return tiled_from_graph(graph, groups=cfg.tiled_groups, cols=cfg.tiled_cols, dtype=dtype)
    if cfg.spmm_mode == "hybrid":
        return hybrid_from_graph(graph, cols=cfg.hybrid_cols, dtype=dtype)
    return ell_from_graph(graph)


class LightGCN(nn.Module):
    """LightGCN on ``device`` (default ``cuda:0``). ``ell`` (an `EllGraph`,
    `TiledGraph` or `HybridGraph`) defaults to the layout of
    ``cfg.spmm_mode`` rebuilt from ``graph`` (`default_layout`); under
    ``spmm_mode="segment"`` the model runs the ELL layout and ignores any
    other, as the JAX package ignores ``ell`` there. ``i2i`` is used only with
    ``cfg.use_item_item`` (and without it no smoothing runs, as in the JAX
    package); ``generator`` is a CPU `torch.Generator` for `init_params`
    (seed 0 when None).

    On a mesh (`gsrs_tpu_torch.parallel.sharding.GraphShardings.place_model`)
    ``ell`` is the rank's shard of the ELL layout and ``layer_sum`` the
    psum that completes each layer's partial rows over the mesh."""

    # the loss is a mean over the batch's rows: a data-axis rank may take
    # its slice of the batch (models whose loss couples the rows say False)
    batch_separable = True

    def __init__(
        self,
        cfg: ModelConfig,
        graph: BipartiteGraph,
        i2i: Optional[ItemItemGraph] = None,
        ell: Optional[Layout] = None,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if cfg.spmm_mode not in ("ell", "hybrid", "tiled", "segment"):
            raise ValueError(
                f"spmm_mode must be 'ell', 'hybrid', 'tiled' or 'segment', got '{cfg.spmm_mode}'"
            )
        device = resolve_device(device)
        self.cfg = cfg
        self.graph = graph
        self.n_users = graph.n_users
        self.m_items = graph.m_items
        if cfg.num_layers == 0:
            ell = None
        elif ell is None or (cfg.spmm_mode == "segment" and not isinstance(ell, EllGraph)):
            ell = default_layout(cfg, graph)
        self.ell = None if ell is None else ell.to(device)
        self.layer_sum: Optional[Callable] = None
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
        self._add_parameters(device)
        self.init_params(generator)

    def _add_parameters(self, device: torch.device) -> None:
        """Register a subclass's further parameters (none here), before
        `init_params` draws them."""

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
        layer (`_layer`)."""
        with span("propagate"):
            u, i = self._tables()
            layer = self._layer(dropout_generator, u.dtype)
            acc_u, acc_i = u, i
            cur_u, cur_i = u, i
            for _ in range(self.cfg.num_layers):
                cur_u, cur_i = layer(cur_u, cur_i)
                acc_u = acc_u + cur_u
                acc_i = acc_i + cur_i
            return self._readout(acc_u, acc_i)

    def _tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The embedding tables in the compute dtype."""
        u, i = self.user_emb, self.item_emb
        if self.cfg.bf16_compute:
            u, i = u.to(torch.bfloat16), i.to(torch.bfloat16)
        return u, i

    def _layer(self, dropout_generator: Optional[torch.Generator], dtype: torch.dtype) -> Layer:
        """One layer of the model's layout, (cur_u, cur_i) → (new_u,
        new_i), with this propagation's dropout drawn once (with
        ``cfg.dropout`` and a generator) for every layer: in canonical edge
        order on the ELL layout (`edge_keep_mask`, the edges JAX's segment
        layout drops in its two sort orders), by the stateless hash on the
        tiled and hybrid ones."""
        g, cfg = self.ell, self.cfg
        masks = None
        if isinstance(g, TiledGraph):
            fn, make = tiled_propagate_layer, lambda gen: tiled_masks(
                g, hashdrop_from_generator(gen, cfg.keep_prob))
        elif isinstance(g, HybridGraph):
            fn, make = hybrid_propagate_layer, lambda gen: hybrid_masks(
                g, hashdrop_from_generator(gen, cfg.keep_prob))
        else:
            fn, make = ell_propagate_layer, lambda gen: edge_keep_mask(
                gen, self.graph, cfg.keep_prob, dtype)
        if dropout_generator is not None and cfg.dropout:
            masks = make(dropout_generator)
        if self.layer_sum is not None:
            return lambda cur_u, cur_i: self.layer_sum(*fn(g, cur_u, cur_i, masks))
        return lambda cur_u, cur_i: fn(g, cur_u, cur_i, masks)

    def _readout(self, acc_u: torch.Tensor, acc_i: torch.Tensor):
        """The layer sums' mean as fp32, then the i2i smoothing."""
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
        both 0.5·Σ‖·‖²/B. Each table's rows are one gather (`gather_rows`:
        one backward launch a table on the card)."""
        u = gather_rows(all_users, users)
        pe, ne = gather_rows_cat(items, pos, neg)
        pos_scores = (u * pe).sum(dim=1)
        neg_scores = (u * ne).sum(dim=1)
        bpr = -F.logsigmoid(pos_scores - neg_scores).mean()
        batch = users.shape[0]
        if self.cfg.reg_mode == "ego":
            u = gather_rows(self.user_emb, users)
            pe, ne = gather_rows_cat(self.item_emb, pos, neg)
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
