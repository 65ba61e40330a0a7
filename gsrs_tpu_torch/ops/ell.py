"""Bucketed-ELL propagation, forward and backward (port of `gsrs_tpu.ops.ell`).

Each direction of the normalized bipartite graph is a set of
degree-bucketed rectangles: bucket row ``rows[i]`` aggregates
``cols[i, :]`` with weights ``w[i, :]``, so one SpMM is a gather-reduce
per bucket (the CUDA kernel of `gsrs_tpu_torch.ops.ell_kernel`, one
launch per side on the card), and the output rows are assembled by one
more gather. Padding slots carry weight 0 and column 0. Rows wider than
``max_width`` are split into chunks; the overflow chunks are added back
into their real rows one chunk level at a time (chunk 1 of every split
row, then chunk 2, ...), so no launch adds twice into one row and the
sums are JAX's, in its order, on every device.

`ell_propagate_layer` is a `torch.autograd.Function` whose backward is
the transpose-side apply through the same kernel, with the same masked
weights, as the JAX package's scatter-free custom VJP: no scatter over
the edges and no atomics in the kernel, in either direction. The
optional ``edge_mask`` (canonical edge order,
`gsrs_tpu_torch.ops.spmm.edge_keep_mask`) scales each slot's weight by
``edge_mask[eidx]``.

The host builders are numpy, exactly the JAX package's, and return CPU
tensors; `EllGraph.to` moves them to the device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from gsrs_tpu_torch.ops.ell_kernel import BucketTable, gather_reduce


@dataclasses.dataclass(frozen=True)
class EllBucket:
    """One degree bucket. ``eidx`` maps each slot to its canonical edge
    index (0 on padding slots, whose weight is 0)."""

    rows: torch.Tensor  # (n_b,) int32 destination row ids
    cols: torch.Tensor  # (n_b, D_b) int32 source row ids, 0-padded
    w: torch.Tensor  # (n_b, D_b) float32 edge weights, 0-padded
    eidx: torch.Tensor  # (n_b, D_b) int32 canonical edge index, 0-padded

    def to(self, device) -> "EllBucket":
        return EllBucket(*(t.to(device) for t in (self.rows, self.cols, self.w, self.eidx)))


@dataclasses.dataclass(frozen=True)
class EllSide:
    """All buckets of one SpMM direction plus the row-assembly gather.

    ``assemble``: (n_rows,) indices into the concatenation of the bucket
    outputs with one zero row appended; zero-degree rows point at it.
    ``extra_levels``: the overflow chunks of rows wider than
    ``max_width``, grouped by chunk index: (dst, pos) of every chunk 1,
    then of every chunk 2, ...; chunk output ``pos[j]`` is added into row
    ``dst[j]``, and the destinations within a level are distinct (the
    JAX package's ``extra_dst``/``extra_pos`` pairs, regrouped). Empty
    when no row was split."""

    buckets: Tuple[EllBucket, ...]
    assemble: torch.Tensor  # (n_rows,) int32
    n_rows: int
    extra_levels: Tuple[Tuple[torch.Tensor, torch.Tensor], ...] = ()  # int32 (dst, pos)

    def to(self, device) -> "EllSide":
        return EllSide(
            buckets=tuple(b.to(device) for b in self.buckets),
            assemble=self.assemble.to(device),
            n_rows=self.n_rows,
            extra_levels=tuple((d.to(device), p.to(device)) for d, p in self.extra_levels),
        )

    @functools.cached_property
    def table(self) -> BucketTable:
        """The buckets as one gather-reduce launch table, built at first
        use on the side's device."""
        return BucketTable([(b.cols, b.w, b.eidx) for b in self.buckets])


@dataclasses.dataclass(frozen=True)
class EllGraph:
    """Both directions of the normalized bipartite graph in ELL form."""

    by_user: EllSide  # dst=users, src=items  (computes W @ item_emb)
    by_item: EllSide  # dst=items, src=users  (computes W^T @ user_emb)
    n_users: int
    m_items: int

    def to(self, device) -> "EllGraph":
        return dataclasses.replace(
            self, by_user=self.by_user.to(device), by_item=self.by_item.to(device)
        )


# ---------------------------------------------------------------- builders


def _build_side(
    dst: np.ndarray,
    src: np.ndarray,
    w: np.ndarray,
    eidx: np.ndarray,
    n_rows: int,
    min_width: int = 4,
    max_width: int = 65536,
) -> EllSide:
    """Group rows by degree into buckets of fine widths (multiples of 4
    up to 64, then powers of two). Rows with degree > ``max_width`` are
    split into ceil(D/max_width) virtual rows whose overflow chunks are
    summed back through ``extra_levels``."""
    order = np.argsort(dst, kind="stable")
    dst, src, w, eidx = dst[order], src[order], w[order], eidx[order]
    degrees = np.bincount(dst, minlength=n_rows)
    row_start = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int64)

    n_real = n_rows
    extra_dst_list, extra_level_list = [], []
    if max_width & (max_width - 1):
        # the width cap relies on pow2 bucket widths: round down to one
        max_width = 1 << (max_width.bit_length() - 1)
    over = np.flatnonzero(degrees > max_width)
    if over.size:
        dst = dst.astype(np.int64, copy=True)
        n_virtual = n_rows
        for r in over:  # few mega rows; a per-row loop is fine
            D = int(degrees[r])
            k = -(-D // max_width)
            pos = row_start[r] + np.arange(D)
            chunk = np.arange(D) // max_width
            dst[pos] = np.where(chunk == 0, r, n_virtual + chunk - 1)
            extra_dst_list.extend([r] * (k - 1))
            extra_level_list.extend(range(k - 1))
            n_virtual += k - 1
        order2 = np.argsort(dst, kind="stable")
        dst, src, w, eidx = dst[order2], src[order2], w[order2], eidx[order2]
        n_rows = n_virtual
        degrees = np.bincount(dst, minlength=n_rows)
        row_start = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int64)

    active_rows = np.flatnonzero(degrees > 0)
    deg_active = degrees[active_rows]
    fine = np.maximum(min_width, ((deg_active + 3) // 4) * 4)
    coarse = 1 << np.ceil(np.log2(np.maximum(deg_active, 1))).astype(np.int64)
    widths = np.where(deg_active <= 64, np.minimum(fine, 64), coarse)
    buckets = []
    concat_pos = np.full(n_rows, -1, dtype=np.int64)
    n_assembled = 0
    for width in np.unique(widths):
        rows = active_rows[widths == width]
        n_b = rows.size
        deg = degrees[rows]
        # slot (k, j) holds the j-th edge of the k-th row of this bucket
        within = np.arange(deg.sum()) - np.repeat(np.cumsum(deg) - deg, deg)
        flat_slot = np.repeat(np.arange(n_b), deg) * width + within
        edge_pos = np.repeat(row_start[rows], deg) + within
        cols = np.zeros(n_b * width, dtype=np.int32)
        ws = np.zeros(n_b * width, dtype=np.float32)
        es = np.zeros(n_b * width, dtype=np.int32)
        cols[flat_slot] = src[edge_pos]
        ws[flat_slot] = w[edge_pos]
        es[flat_slot] = eidx[edge_pos]
        buckets.append(
            (rows.astype(np.int32), cols.reshape(n_b, width), ws.reshape(n_b, width),
             es.reshape(n_b, width))
        )
        concat_pos[rows] = n_assembled + np.arange(n_b)
        n_assembled += n_b
    # zero-degree rows → the appended zero row at index n_assembled
    assemble = np.where(concat_pos >= 0, concat_pos, n_assembled).astype(np.int32)
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    levels = []
    if extra_dst_list:
        extra_dst = np.asarray(extra_dst_list, dtype=np.int32)
        extra_pos = assemble[n_real:]  # virtual rows all have degree > 0
        # bucket rows carry the REAL destination id of overflow chunks
        buckets = [
            (np.where(r >= n_real, extra_dst[np.maximum(r, n_real) - n_real], r).astype(np.int32),
             c, ws, es)
            for r, c, ws, es in buckets
        ]
        level = np.asarray(extra_level_list)
        levels = [(t(extra_dst[level == j]), t(extra_pos[level == j]))
                  for j in range(int(level.max()) + 1)]
    return EllSide(
        buckets=tuple(EllBucket(*(t(a) for a in b)) for b in buckets),
        assemble=t(assemble[:n_real]),
        n_rows=n_real,
        extra_levels=tuple(levels),
    )


def build_ell_graph(
    users: np.ndarray,
    items: np.ndarray,
    weights: np.ndarray,
    n_users: int,
    m_items: int,
    min_width: int = 4,
    max_width: int = 65536,
) -> EllGraph:
    """Build from canonical (unpadded) edge arrays and their normalized
    weights (`gsrs_tpu_torch.data.adjacency.normalized_edge_weights`)."""
    eidx = np.arange(users.size, dtype=np.int32)
    return EllGraph(
        by_user=_build_side(users, items, weights, eidx, n_users, min_width, max_width),
        by_item=_build_side(items, users, weights, eidx, m_items, min_width, max_width),
        n_users=n_users,
        m_items=m_items,
    )


def ell_from_graph(graph, min_width: int = 4) -> EllGraph:
    """Rebuild the ELL layout from a BipartiteGraph's padded edge arrays
    (`canonical_edges`: canonical order, padding dropped)."""
    from gsrs_tpu_torch.data.adjacency import canonical_edges

    users, items, w = canonical_edges(graph)
    return build_ell_graph(users, items, w, graph.n_users, graph.m_items, min_width)


def ell_from_interactions(data, min_width: int = 4) -> EllGraph:
    """Build the ELL graph straight from an InteractionData."""
    from gsrs_tpu_torch.data.adjacency import normalized_edge_weights

    w = normalized_edge_weights(
        data.train_users, data.train_items, data.user_degrees, data.item_degrees
    )
    return build_ell_graph(
        data.train_users.astype(np.int32),
        data.train_items.astype(np.int32),
        w,
        data.n_users,
        data.m_items,
        min_width=min_width,
    )


# ----------------------------------------------------------------- apply


def _apply_side(
    side: EllSide, x: torch.Tensor, edge_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """out[r] = Σ_slots w · x[col] for every row r of this side. The
    gather-reduce writes each bucket's rows straight into its place in
    the concatenation of bucket outputs, whose last row stays zero for
    the zero-degree rows to gather."""
    table = side.table
    concat = x.new_empty(table.n_rows + 1, x.shape[-1])
    concat[table.n_rows].zero_()
    gather_reduce(table, x.contiguous(), edge_mask, out=concat)
    out = concat.index_select(0, side.assemble)
    for dst, pos in side.extra_levels:
        # overflow chunks of split mega rows (see EllSide), one chunk level
        # a launch: its rows are distinct, so each gets one add, in chunk order
        out.index_add_(0, dst, concat.index_select(0, pos))
    return out


class _EllLayer(torch.autograd.Function):
    """Forward: both sides' apply. Backward: W^T ĝ_u is the item-side
    apply of ĝ_u and W ĝ_i the user-side apply of ĝ_i, with the same
    masked weights; no gradient flows to the graph or the mask."""

    @staticmethod
    def forward(ctx, graph, user_emb, item_emb, edge_mask):
        ctx.graph, ctx.edge_mask = graph, edge_mask
        ctx.dtypes = (user_emb.dtype, item_emb.dtype)
        return (_apply_side(graph.by_user, item_emb, edge_mask),
                _apply_side(graph.by_item, user_emb, edge_mask))

    @staticmethod
    def backward(ctx, g_u, g_i):
        graph, mask = ctx.graph, ctx.edge_mask
        u_dtype, i_dtype = ctx.dtypes
        d_item = _apply_side(graph.by_item, g_u, mask).to(i_dtype)
        d_user = _apply_side(graph.by_user, g_i, mask).to(u_dtype)
        return None, d_user, d_item, None


def ell_propagate_layer(
    graph: EllGraph,
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    edge_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LightGCN layer, scatter-free in both passes: new_user =
    W @ item_emb, new_item = W^T @ user_emb. ``edge_mask``: optional (E,)
    per-edge weight scale in canonical edge order (cast to fp32 for the
    kernel; its values are those of the caller's dtype)."""
    if edge_mask is not None:
        edge_mask = edge_mask.detach().float().contiguous()
    return _EllLayer.apply(graph, user_emb, item_emb, edge_mask)


class _EllSpmm(torch.autograd.Function):
    """``A @ x`` for a square A held as an EllGraph over its (row, col)
    entries: the forward is the ``by_user`` side (rows ← cols), the
    backward Aᵀ ĝ the ``by_item`` side (cols ← rows), built from the same
    entries rather than assumed equal, so A need not be symmetric."""

    @staticmethod
    def forward(ctx, graph, x):
        ctx.graph, ctx.dtype = graph, x.dtype
        return _apply_side(graph.by_user, x)

    @staticmethod
    def backward(ctx, g):
        return None, _apply_side(ctx.graph.by_item, g).to(ctx.dtype)


def ell_spmm(graph: EllGraph, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` through the ELL gather-reduce, forward and backward, for
    the square A whose ELL form is ``graph`` (`build_ell_graph` over A's
    entries as (row, col, value) with n_users = m_items = A's size)."""
    return _EllSpmm.apply(graph, x)
