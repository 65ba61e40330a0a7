"""Tiled SpMM: per-row-group dense hub blocks + residual ELL (port of
`gsrs_tpu.ops.tiled`).

Clustering rows first (the spectral order of `gsrs_tpu_torch.ops.reorder`)
and giving each contiguous row GROUP its own top-C hub columns puts most
edges of a power-law graph into dense blocks, because communities share
their own hubs. Layout per direction (dst ← src):

- rows permuted into G contiguous cluster groups (``order_dst``);
- ``dense``: (G·rows_g, C) in the compute dtype: row r' of group g holds
  the weights of its edges into that group's ``top_src[g]`` column set;
- apply = gather the G·C hub source rows, one (G, rows_g, C) × (G, C, d)
  `torch.bmm`, and one n_dst-row gather back to natural order;
- backward is scatter-free: the group-transpose `torch.bmm` (on the
  dense block's transposed view, not a copy) gives hub cotangents
  (G·C, d), accumulated into source nodes through ``occ``, an `EllSide`
  whose "edges" are the hub-slot occurrences (≤ G per node);
- everything not covered rides a residual `EllGraph` in natural id
  space, whose ``by_user`` slot is the dst side (forward) and ``by_item``
  the src side (backward).

The residual and ``occ`` applies are K4 calls (`ops.ell._apply_side` →
``csrc/ell_gather_reduce.cu`` on the card); the grouped product is a
plain batched matrix product left to `torch.bmm`, as the JAX package
leaves its einsum to XLA. With bf16 the sums are rounded where JAX
rounds them: the product once to bf16 (`_hub_product` keeps cuBLAS's
accumulation in fp32), the residual in bf16, then their sum in bf16; in
the backward the hub cotangents are bf16 before ``occ``.

Edge dropout is the stateless hash mask (`ops.hashdrop`): the dense
cells' mask is ``hash_keep(row_nat, top_src)`` in canonical (user, item)
order, and the residual's is ``hash_keep`` over the residual's canonical
edge list (kept here, ``res_dst``/``res_src``), read by K4 through each
slot's ``eidx``: the same decisions as JAX's per-slot hash.
`tiled_masks` computes both once per step; every layer and the backward
reuse them.

Builders are numpy (the JAX package's statements) and return CPU
tensors; `TiledGraph.to` moves them to the device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gsrs_tpu_torch.ops.ell import EllGraph, EllSide, _apply_side, _build_side
from gsrs_tpu_torch.ops.hashdrop import HashDrop, hash_keep
from gsrs_tpu_torch.ops.linalg import fp32_reduction


@dataclasses.dataclass(frozen=True)
class TiledDirection:
    """One propagation direction (dst ← src)."""

    dense: torch.Tensor  # (G*rows_g, C) grouped hub weights, compute dtype
    top_src: torch.Tensor  # (G, C) int32 natural source ids (pad: 0, w=0)
    slot_w: torch.Tensor  # (G, C) fp32 occ's weights: 1 on a real hub slot, 0 on padding
    order_dst: torch.Tensor  # (n_dst,) int32: natural row -> grouped position
    row_nat: torch.Tensor  # (G*rows_g,) int32: grouped position -> natural row
    occ: EllSide  # hub-slot occurrences per source node (backward accum)
    residual: EllGraph  # by_user = dst side (fwd), by_item = src side (VJP)
    res_dst: torch.Tensor  # (E_res,) int32 dst id of each residual edge (its eidx)
    res_src: torch.Tensor  # (E_res,) int32 src id of each residual edge
    groups: int
    rows_g: int
    cols: int
    # False on the ranks of a mesh that hold a replicated dense block but
    # leave its product to the one rank that counts it (`parallel.sharding`)
    adds_dense: bool = True

    def to(self, device) -> "TiledDirection":
        return dataclasses.replace(
            self,
            **{k: getattr(self, k).to(device)
               for k in ("dense", "top_src", "slot_w", "order_dst", "row_nat", "occ",
                         "residual", "res_dst", "res_src")},
        )


@dataclasses.dataclass(frozen=True)
class TiledGraph:
    user_from_item: TiledDirection  # new_u = W @ item_emb
    item_from_user: TiledDirection  # new_i = Wᵀ @ user_emb
    n_users: int
    m_items: int

    def to(self, device) -> "TiledGraph":
        return dataclasses.replace(self, user_from_item=self.user_from_item.to(device),
                                   item_from_user=self.item_from_user.to(device))


def _build_tiled_direction(
    dst: np.ndarray,
    src: np.ndarray,
    w: np.ndarray,
    n_dst: int,
    n_src: int,
    order_dst: np.ndarray,
    groups: int,
    cols: int,
    dtype: torch.dtype,
    min_width: int,
) -> TiledDirection:
    G = int(min(groups, n_dst))
    C = int(min(cols, n_src))
    rows_g = -(-n_dst // G)
    n_pad = G * rows_g
    newdst = order_dst[dst]
    g_of_edge = newdst // rows_g

    # fp32 here; rounded to the compute dtype (nearest even, as numpy's
    # bf16 cast in the JAX package) when it becomes a tensor below
    dense = np.zeros((n_pad, C), np.float32)
    top_src = np.zeros((G, C), np.int32)
    occ_w = np.zeros((G, C), np.float32)
    in_dense = np.zeros(dst.size, bool)
    for gi in range(G):
        sel = np.flatnonzero(g_of_edge == gi)
        if sel.size == 0:
            continue
        deg = np.bincount(src[sel], minlength=n_src)
        c_eff = int(min(C, (deg > 0).sum()))
        # reversed stable sort: among equal degrees the higher id leads
        top = np.argsort(deg, kind="stable")[::-1][:c_eff].astype(np.int32)
        top_src[gi, :c_eff] = top
        occ_w[gi, :c_eff] = 1.0
        rank = np.full(n_src, -1, np.int64)
        rank[top] = np.arange(c_eff)
        r_sel = rank[src[sel]]
        ok = r_sel >= 0
        idxs = sel[ok]
        dense[newdst[idxs], r_sel[ok]] = w[idxs].astype(np.float32)
        in_dense[idxs] = True

    # padded rows stay 0: the backward's gather reads g[0] into all-zero
    # dense rows, so the index stays valid and the product stays 0
    row_nat = np.zeros(n_pad, np.int32)
    row_nat[order_dst] = np.arange(n_dst, dtype=np.int32)

    res = ~in_dense
    eidx = np.arange(int(res.sum()), dtype=np.int32)
    residual = EllGraph(
        by_user=_build_side(dst[res], src[res], w[res], eidx, n_dst, min_width),
        by_item=_build_side(src[res], dst[res], w[res], eidx, n_src, min_width),
        n_users=n_dst,
        m_items=n_src,
    )
    return TiledDirection(
        dense=torch.from_numpy(dense).to(dtype),
        top_src=torch.from_numpy(top_src),
        slot_w=torch.from_numpy(occ_w),
        order_dst=torch.from_numpy(order_dst.astype(np.int32)),
        row_nat=torch.from_numpy(row_nat),
        occ=occ_side(top_src, occ_w, n_src, min_width),
        residual=residual,
        res_dst=torch.from_numpy(dst[res].astype(np.int32)),
        res_src=torch.from_numpy(src[res].astype(np.int32)),
        groups=G,
        rows_g=rows_g,
        cols=C,
    )


def occ_side(top_src: np.ndarray, slot_w: np.ndarray, n_src: int, min_width: int = 4) -> EllSide:
    """The backward's accumulation side over (G, C) hub slots: "edges"
    (source node ← hub slot g·C + c) weighted by ``slot_w``, 1 for a real
    slot and 0 for padding (padded slots alias node 0, but their dense
    column is all-zero, so they are doubly inert)."""
    n = top_src.size
    return _build_side(top_src.reshape(-1).astype(np.int64), np.arange(n, dtype=np.int64),
                       slot_w.reshape(-1), np.arange(n, dtype=np.int32), n_src, min_width)


def _build_tiled_graph(users, items, w, n_users, m_items, groups, cols, dtype, min_width,
                       seed, orders=None) -> TiledGraph:
    """Both directions over ``orders`` = (order_u, order_i), by default
    the spectral order with max(groups, 2) clusters."""
    from gsrs_tpu_torch.ops.reorder import spectral_cluster_order

    order_u, order_i = orders if orders is not None else spectral_cluster_order(
        users, items, n_users, m_items, n_clusters=max(groups, 2), seed=seed,
    )
    return TiledGraph(
        user_from_item=_build_tiled_direction(
            users, items, w, n_users, m_items, order_u, groups, cols, dtype, min_width,
        ),
        item_from_user=_build_tiled_direction(
            items, users, w, m_items, n_users, order_i, groups, cols, dtype, min_width,
        ),
        n_users=n_users,
        m_items=m_items,
    )


def tiled_from_interactions(
    data,
    groups: int = 32,
    cols: int = 4096,
    dtype: torch.dtype = torch.float32,
    min_width: int = 4,
    seed: int = 0,
    hbm_budget_gb: Optional[float] = None,
) -> TiledGraph:
    """Build from an InteractionData with the reference's exact symmetric
    normalization (the weights of `ops.ell.ell_from_interactions`). The
    spectral order is deterministic (fixed SVD start vector + seeded
    k-means), so a rebuild reproduces the identical layout. ``dtype``:
    the dense blocks' compute dtype (torch.float32 or torch.bfloat16)."""
    from gsrs_tpu_torch.data.adjacency import normalized_edge_weights
    from gsrs_tpu_torch.ops.hybrid import DENSE_HBM_BUDGET_GB, resolve_hybrid_cols

    w = normalized_edge_weights(
        data.train_users, data.train_items, data.user_degrees, data.item_degrees
    ).astype(np.float32)
    users = data.train_users.astype(np.int64)
    items = data.train_items.astype(np.int64)
    # the hybrid layout's memory guard: dense rows total n+m at C cols each
    cols = resolve_hybrid_cols(
        data.n_users, data.m_items, cols, dtype,
        DENSE_HBM_BUDGET_GB if hbm_budget_gb is None else hbm_budget_gb,
    )
    return _build_tiled_graph(users, items, w, data.n_users, data.m_items, groups, cols, dtype,
                              min_width, seed)


def tiled_from_graph(
    graph,
    groups: int = 32,
    cols: int = 4096,
    dtype: torch.dtype = torch.float32,
    min_width: int = 4,
    seed: int = 0,
) -> TiledGraph:
    """Build from a BipartiteGraph's padded edge arrays
    (`canonical_edges`: canonical order, padding dropped)."""
    from gsrs_tpu_torch.data.adjacency import canonical_edges
    from gsrs_tpu_torch.ops.hybrid import resolve_hybrid_cols

    users, items, w = canonical_edges(graph)
    users, items = users.astype(np.int64), items.astype(np.int64)
    cols = resolve_hybrid_cols(graph.n_users, graph.m_items, cols, dtype)
    return _build_tiled_graph(users, items, w, graph.n_users, graph.m_items, groups, cols, dtype,
                              min_width, seed)


# ----------------------------------------------------------------- apply


class DirectionMask(NamedTuple):
    """One direction's dropout for one step: the masked dense block and
    the (E_res,) fp32 mask of the residual edges in eidx order."""

    dense: torch.Tensor
    residual: torch.Tensor


def _masked_dense(d: TiledDirection, drop: HashDrop, dst_is_user: bool) -> torch.Tensor:
    """Grouped dense block with the stateless per-edge keep mask applied:
    cell (r', c) is edge (row_nat[r'], top_src[g(r'), c]); the hash sees
    canonical (user, item) order so the decision agrees with the residual
    and the transpose direction."""
    rows = d.row_nat[:, None]  # (G*rows_g, 1) natural dst ids
    cols = d.top_src.repeat_interleave(d.rows_g, dim=0)  # (G*rows_g, C)
    uu, ii = (rows, cols) if dst_is_user else (cols, rows)
    return d.dense * hash_keep(uu, ii, drop, dtype=d.dense.dtype)


def _direction_mask(d: TiledDirection, drop: HashDrop, dst_is_user: bool) -> DirectionMask:
    uu, ii = (d.res_dst, d.res_src) if dst_is_user else (d.res_src, d.res_dst)
    # a rank that leaves a replicated block's product to another adds none: no mask for it
    dense = _masked_dense(d, drop, dst_is_user) if d.adds_dense else d.dense
    return DirectionMask(dense, hash_keep(uu, ii, drop))


def tiled_masks(tg: TiledGraph, drop: Optional[HashDrop]):
    """Both directions' masks for one step (None without dropout)."""
    if drop is None:
        return None
    return (_direction_mask(tg.user_from_item, drop, True),
            _direction_mask(tg.item_from_user, drop, False))


def _hub_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The grouped product ``torch.bmm(a, b)``, summed in fp32 and rounded
    once to the inputs' dtype."""
    with fp32_reduction():
        return torch.bmm(a, b)


def _apply_direction(
    d: TiledDirection, x: torch.Tensor, mask: Optional[DirectionMask] = None
) -> torch.Tensor:
    out = _apply_side(d.residual.by_user, x, None if mask is None else mask.residual)
    G, rows_g, C = d.groups, d.rows_g, d.cols
    # memory guard degenerate (dense blocks disabled, pure ELL), or another rank's block
    if C == 0 or not d.adds_dense:
        return out
    xg = x.index_select(0, d.top_src.reshape(-1)).reshape(G, C, -1)
    dd = (d.dense if mask is None else mask.dense).to(x.dtype)
    y = _hub_product(dd.view(G, rows_g, C), xg).reshape(G * rows_g, -1)
    # back to natural row order: a bijection gather, never a scatter
    return out + y.index_select(0, d.order_dst)


def _apply_direction_t(
    d: TiledDirection, g: torch.Tensor, mask: Optional[DirectionMask] = None
) -> torch.Tensor:
    """Wᵀ @ g: transpose-ELL residual + group-transpose product whose
    (G·C, dim) hub cotangents accumulate scatter-free through ``occ``."""
    out = _apply_side(d.residual.by_item, g, None if mask is None else mask.residual)
    G, rows_g, C = d.groups, d.rows_g, d.cols
    if C == 0 or not d.adds_dense:
        return out
    gy = g.index_select(0, d.row_nat)  # (G*rows_g, dim); pad rows hit
    # all-zero dense rows, so their duplicated cotangent contributes 0
    dd = (d.dense if mask is None else mask.dense).to(g.dtype)
    hub_cot = _hub_product(dd.view(G, rows_g, C).transpose(1, 2),
                           gy.view(G, rows_g, -1)).reshape(G * C, -1)
    return out + _apply_side(d.occ, hub_cot.to(g.dtype))


class _TiledLayer(torch.autograd.Function):
    """Forward: both directions' apply. Backward: their transposes with
    the same masks; no gradient flows to the graph or the masks."""

    @staticmethod
    def forward(ctx, tg, user_emb, item_emb, masks):
        ctx.tg, ctx.masks = tg, masks
        ctx.dtypes = (user_emb.dtype, item_emb.dtype)
        m_u, m_i = (None, None) if masks is None else masks
        return (_apply_direction(tg.user_from_item, item_emb, m_u),
                _apply_direction(tg.item_from_user, user_emb, m_i))

    @staticmethod
    def backward(ctx, g_u, g_i):
        tg, masks = ctx.tg, ctx.masks
        u_dtype, i_dtype = ctx.dtypes
        m_u, m_i = (None, None) if masks is None else masks
        d_item = _apply_direction_t(tg.user_from_item, g_u.contiguous(), m_u).to(i_dtype)
        d_user = _apply_direction_t(tg.item_from_user, g_i.contiguous(), m_i).to(u_dtype)
        return None, d_user, d_item, None


def tiled_propagate_layer(
    tg: TiledGraph,
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    masks: Optional[Tuple[DirectionMask, DirectionMask]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LightGCN layer: new_u = W @ item_emb, new_i = Wᵀ @ user_emb;
    per-group hub blocks through `torch.bmm`, residual edges through K4,
    scatter-free in both passes. ``masks``: the step's dropout,
    `tiled_masks(tg, drop)`, computed once and reused by every layer."""
    return _TiledLayer.apply(tg, user_emb, item_emb, masks)
