"""Hybrid SpMM: dense hub-column blocks + residual ELL (port of
`gsrs_tpu.ops.hybrid`).

Each direction ``W`` (dst ← src) splits into ``W_dense + W_residual``:

- ``dense``: the (n_dst, C) submatrix over the C highest-degree source
  columns (``top_src``), in the compute dtype. Applying it is one product
  ``dense @ x[top_src]``, a plain matrix product left to `torch.matmul`
  as the JAX package leaves its ``jnp.dot`` to XLA, with its fp32
  reduction pinned (`ops.tiled._hub_product`), so a bf16 product is
  rounded once, as JAX rounds it.
- ``residual``: every other edge, an `EllGraph` whose ``by_user`` side is
  the forward (dst) side and ``by_item`` the transpose (src) side; both go
  through the ELL gather-reduce (K4, ``csrc/ell_gather_reduce.cu`` on
  the card).

The backward is scatter-free on the residual (its transpose side) and
adds ``denseᵀ @ ĝ`` into the C hub rows of the cotangent: ``top_src`` is
distinct, so that `index_add_` adds once into each row.

Edge dropout is the stateless hash mask (`ops.hashdrop`), as in the
tiled layout: a dense cell (r, c) is the edge (r, top_src[c]), and the
residual's mask is ``hash_keep`` over its canonical edge list
(``res_dst``/``res_src``), read by K4 through each slot's ``eidx``. The
hash sees canonical (user, item) order, so both directions and the
dense/residual split drop the same edges. `hybrid_masks` computes both
directions' masks once per step; every layer and the backward reuse them.
The dense block's mask is hashed at its nonzero cells only
(``dense_dst``/``dense_col``, a fraction of a percent of the block at
Gowalla's shape): a zero cell stays zero whatever its hash, so the masked
block is the JAX package's cell for cell, without a hash of every cell
each step.

The dense-block memory guard (``DENSE_HBM_BUDGET_GB``,
`resolve_hybrid_cols`) is shared with the tiled layout. Its constructors are
numpy, the JAX package's statements, and return CPU tensors;
`HybridGraph.to` moves them to the device.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from gsrs_tpu_torch.ops.ell import EllGraph, _apply_side, _build_side
from gsrs_tpu_torch.ops.hashdrop import HashDrop, hash_keep
from gsrs_tpu_torch.ops.tiled import DirectionMask, _hub_product

# Device-memory budget for the two dense hub blocks combined
# (user_from_item is (n_users, C), item_from_user is (m_items, C)): room
# is left for the embedding tables, the optimizer state, activations and
# the residual ELL. The blocks are O((n+m)·C), so at a 50M-user/10M-item
# shape they would need ~0.9 TB: `resolve_hybrid_cols` clamps C (down to
# 0 = plain ELL) with a warning instead of running out of memory.
DENSE_HBM_BUDGET_GB = 4.0


def resolve_hybrid_cols(
    n_users: int,
    m_items: int,
    cols: int,
    dtype: torch.dtype,
    hbm_budget_gb: float = DENSE_HBM_BUDGET_GB,
) -> int:
    """Clamp the hub-column count so the two dense blocks fit the budget.
    Returns ``cols`` unchanged when it fits; otherwise the largest
    128-multiple that does (possibly 0 — the dense blocks become empty
    and the layout degenerates to plain ELL), with a warning that names
    the estimate and the alternative."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    rows = n_users + m_items
    budget = int(hbm_budget_gb * 1024**3)
    need = rows * cols * itemsize
    if need <= budget:
        return cols
    fit = (budget // (rows * itemsize) // 128) * 128
    fit = int(max(fit, 0))
    warnings.warn(
        f"hybrid dense blocks at C={cols} would need "
        f"{need / 1024**3:.1f} GiB for {n_users}+{m_items} node rows "
        f"(budget {hbm_budget_gb:.1f} GiB); clamping to C={fit}"
        + (
            " — dense blocks disabled, effectively plain ELL. Use "
            "--spmm ell (and a sharded mesh) at this scale."
            if fit == 0
            else ". Raise hbm_budget_gb only if the chip has headroom."
        ),
        stacklevel=3,
    )
    return fit


@dataclasses.dataclass(frozen=True)
class HybridDirection:
    """One propagation direction (dst ← src)."""

    residual: EllGraph  # by_user = dst side (forward), by_item = src side (VJP)
    dense: torch.Tensor  # (n_dst, C) hub-column weights, compute dtype
    top_src: torch.Tensor  # (C,) int32 source ids of the dense columns, distinct
    res_dst: torch.Tensor  # (E_res,) int32 dst id of each residual edge (its eidx)
    res_src: torch.Tensor  # (E_res,) int32 src id of each residual edge
    dense_dst: torch.Tensor  # (E_dense,) int64 row of each nonzero dense cell
    dense_col: torch.Tensor  # (E_dense,) int64 column of each nonzero dense cell
    # False on the ranks of a mesh that hold a replicated dense block but
    # leave its product to the one rank that counts it (`parallel.sharding`)
    adds_dense: bool = True

    def to(self, device) -> "HybridDirection":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
            if f.name != "adds_dense"})


@dataclasses.dataclass(frozen=True)
class HybridGraph:
    user_from_item: HybridDirection  # new_u = W @ item_emb
    item_from_user: HybridDirection  # new_i = Wᵀ @ user_emb
    n_users: int
    m_items: int

    def to(self, device) -> "HybridGraph":
        return dataclasses.replace(self, user_from_item=self.user_from_item.to(device),
                                   item_from_user=self.item_from_user.to(device))


def _build_direction(
    dst: np.ndarray,
    src: np.ndarray,
    w: np.ndarray,
    n_dst: int,
    n_src: int,
    src_degrees: np.ndarray,
    cols: int,
    dtype: torch.dtype,
    min_width: int,
) -> HybridDirection:
    c = int(min(cols, n_src))
    # round down to a lane-friendly multiple (keep small graphs exact)
    if c >= 128 and c < n_src:
        c = (c // 128) * 128
    # reversed stable sort: among equal degrees the higher id leads
    top = np.argsort(src_degrees, kind="stable")[::-1][:c].astype(np.int32)
    rank = np.full(n_src, -1, dtype=np.int64)
    rank[top] = np.arange(c)
    in_dense = rank[src] >= 0

    # fp32 here; rounded to the compute dtype (nearest even, as numpy's
    # bf16 cast in the JAX package) when it becomes a tensor below
    dense = np.zeros((n_dst, c), dtype=np.float32)
    dense_dst, dense_col = dst[in_dense].astype(np.int64), rank[src[in_dense]]
    dense[dense_dst, dense_col] = w[in_dense].astype(np.float32)

    res = ~in_dense
    eidx = np.arange(res.sum(), dtype=np.int32)
    residual = EllGraph(
        by_user=_build_side(dst[res], src[res], w[res], eidx, n_dst, min_width),
        by_item=_build_side(src[res], dst[res], w[res], eidx, n_src, min_width),
        n_users=n_dst,
        m_items=n_src,
    )
    return HybridDirection(
        residual=residual,
        dense=torch.from_numpy(dense).to(dtype),
        top_src=torch.from_numpy(top),
        res_dst=torch.from_numpy(dst[res].astype(np.int32)),
        res_src=torch.from_numpy(src[res].astype(np.int32)),
        dense_dst=torch.from_numpy(dense_dst),
        dense_col=torch.from_numpy(dense_col),
    )


def _build_hybrid_graph(users, items, w, n_users, m_items, cols, dtype, min_width,
                        hbm_budget_gb) -> HybridGraph:
    item_deg = np.bincount(items, minlength=m_items)
    user_deg = np.bincount(users, minlength=n_users)
    cols = resolve_hybrid_cols(n_users, m_items, cols, dtype, hbm_budget_gb)
    return HybridGraph(
        user_from_item=_build_direction(users, items, w, n_users, m_items, item_deg, cols,
                                        dtype, min_width),
        item_from_user=_build_direction(items, users, w, m_items, n_users, user_deg, cols,
                                        dtype, min_width),
        n_users=n_users,
        m_items=m_items,
    )


def hybrid_from_interactions(
    data, cols: int = 8192, dtype: torch.dtype = torch.float32, min_width: int = 4,
    hbm_budget_gb: float = DENSE_HBM_BUDGET_GB,
) -> HybridGraph:
    """Build from an InteractionData with the reference's symmetric
    normalization (the weights of `ops.ell.ell_from_interactions`).
    ``dtype``: the dense blocks' compute dtype (torch.float32 or
    torch.bfloat16)."""
    from gsrs_tpu_torch.data.adjacency import normalized_edge_weights

    w = normalized_edge_weights(
        data.train_users, data.train_items, data.user_degrees, data.item_degrees
    ).astype(np.float32)
    return _build_hybrid_graph(data.train_users.astype(np.int32),
                               data.train_items.astype(np.int32), w, data.n_users,
                               data.m_items, cols, dtype, min_width, hbm_budget_gb)


def hybrid_from_graph(
    graph, cols: int = 8192, dtype: torch.dtype = torch.float32, min_width: int = 4,
    hbm_budget_gb: float = DENSE_HBM_BUDGET_GB,
) -> HybridGraph:
    """Build from a BipartiteGraph's padded edge arrays
    (`canonical_edges`: canonical order, padding dropped)."""
    from gsrs_tpu_torch.data.adjacency import canonical_edges

    users, items, w = canonical_edges(graph)
    return _build_hybrid_graph(users, items, w, graph.n_users, graph.m_items, cols, dtype,
                               min_width, hbm_budget_gb)


# ----------------------------------------------------------------- apply


def _masked_dense(d: HybridDirection, drop: HashDrop, dst_is_user: bool) -> torch.Tensor:
    """The dense block with the per-edge keep mask applied: cell (r, c)
    is edge (r, top_src[c]), hashed in canonical (user, item) order; only
    the nonzero cells are hashed and scaled (distinct cells: a plain
    store, no accumulation)."""
    r, c = d.dense_dst, d.dense_col
    src = d.top_src.index_select(0, c)
    uu, ii = (r, src) if dst_is_user else (src, r)
    out = d.dense.clone()
    out[r, c] = d.dense[r, c] * hash_keep(uu, ii, drop, dtype=d.dense.dtype)
    return out


def _direction_mask(d: HybridDirection, drop: HashDrop, dst_is_user: bool) -> DirectionMask:
    uu, ii = (d.res_dst, d.res_src) if dst_is_user else (d.res_src, d.res_dst)
    # a rank that leaves a replicated block's product to another adds none: no mask for it
    dense = _masked_dense(d, drop, dst_is_user) if d.adds_dense else d.dense
    return DirectionMask(dense, hash_keep(uu, ii, drop))


def hybrid_masks(hg: HybridGraph, drop: Optional[HashDrop]):
    """Both directions' masks for one step (None without dropout)."""
    if drop is None:
        return None
    return (_direction_mask(hg.user_from_item, drop, True),
            _direction_mask(hg.item_from_user, drop, False))


def _dense_block(d: HybridDirection, mask: Optional[DirectionMask], dtype) -> torch.Tensor:
    """The (masked) dense block cast to the product's dtype, as JAX casts
    it before ``jnp.dot``."""
    return (d.dense if mask is None else mask.dense).to(dtype)


def _apply_direction(
    d: HybridDirection, x: torch.Tensor, mask: Optional[DirectionMask] = None
) -> torch.Tensor:
    out = _apply_side(d.residual.by_user, x, None if mask is None else mask.residual)
    # memory guard degenerate (dense blocks disabled, pure ELL), or another rank's block
    if d.top_src.numel() == 0 or not d.adds_dense:
        return out
    hub = x.index_select(0, d.top_src)  # (C, dim)
    return out + _hub_product(_dense_block(d, mask, x.dtype)[None], hub[None])[0]


def _apply_direction_t(
    d: HybridDirection, g: torch.Tensor, mask: Optional[DirectionMask] = None
) -> torch.Tensor:
    """Wᵀ @ g for one direction: the residual's transpose side plus the
    dense block's transposed product added into the C hub rows."""
    out = _apply_side(d.residual.by_item, g, None if mask is None else mask.residual)
    if d.top_src.numel() == 0 or not d.adds_dense:
        return out
    # the transposed view, not a copy
    hub_cot = _hub_product(_dense_block(d, mask, g.dtype).t()[None], g[None])[0]  # (C, dim)
    # top_src is distinct: one add into each of the C rows, in any order
    return out.index_add_(0, d.top_src, hub_cot)


class _HybridLayer(torch.autograd.Function):
    """Forward: both directions' apply. Backward: their transposes with
    the same masks; no gradient flows to the graph or the masks."""

    @staticmethod
    def forward(ctx, hg, user_emb, item_emb, masks):
        ctx.hg, ctx.masks = hg, masks
        ctx.dtypes = (user_emb.dtype, item_emb.dtype)
        m_u, m_i = (None, None) if masks is None else masks
        return (_apply_direction(hg.user_from_item, item_emb, m_u),
                _apply_direction(hg.item_from_user, user_emb, m_i))

    @staticmethod
    def backward(ctx, g_u, g_i):
        hg, masks = ctx.hg, ctx.masks
        u_dtype, i_dtype = ctx.dtypes
        m_u, m_i = (None, None) if masks is None else masks
        d_item = _apply_direction_t(hg.user_from_item, g_u.contiguous(), m_u).to(i_dtype)
        d_user = _apply_direction_t(hg.item_from_user, g_i.contiguous(), m_i).to(u_dtype)
        return None, d_user, d_item, None


def hybrid_propagate_layer(
    hg: HybridGraph,
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    masks: Optional[Tuple[DirectionMask, DirectionMask]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LightGCN layer: new_u = W @ item_emb, new_i = Wᵀ @ user_emb;
    hub columns through one product, residual edges through K4,
    scatter-free in both passes but for the C distinct hub rows.
    ``masks``: the step's dropout, `hybrid_masks(hg, drop)`, computed once
    and reused by every layer."""
    return _HybridLayer.apply(hg, user_emb, item_emb, masks)
