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
from typing import Optional, Sequence, Tuple

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


# ---------------------------------------------------- mesh-even padding


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def flat_extras(side: EllSide) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The overflow chunks as the JAX package holds them: (extra_dst,
    extra_pos) in row order, each row's chunks in chunk order; None when
    no row was split."""
    if not side.extra_levels:
        return None
    dst = np.concatenate([_np(d) for d, _ in side.extra_levels])
    pos = np.concatenate([_np(p) for _, p in side.extra_levels])
    level = np.concatenate([np.full(d.shape[0], j) for j, (d, _) in enumerate(side.extra_levels)])
    order = np.lexsort((level, dst))
    return dst[order].astype(np.int32), pos[order].astype(np.int32)


def chunk_levels(extra_dst: np.ndarray, extra_pos: np.ndarray):
    """Flat overflow chunks (row order, chunk order within a row) grouped
    into `EllSide.extra_levels`: level j holds every row's (j+1)-th chunk,
    so the destinations of a level are distinct."""
    order = np.argsort(extra_dst, kind="stable")
    d = extra_dst[order]
    start = np.flatnonzero(np.r_[True, d[1:] != d[:-1]])
    occ = np.empty(d.size, np.int64)
    occ[order] = np.arange(d.size) - np.repeat(start, np.diff(np.r_[start, d.size]))
    return tuple((_t(extra_dst[occ == j].astype(np.int32)), _t(extra_pos[occ == j].astype(np.int32)))
                 for j in range(int(occ.max()) + 1 if d.size else 0))


def pad_ell_graph(ell: EllGraph, multiple: int) -> EllGraph:
    """Pad every bucket's row count to a multiple of ``multiple`` (zero
    rows, cols and weights: the padded rows compute zeros that no
    assemble entry points at) and rebuild each side's assemble map and
    overflow positions for the shifted concat offsets, so the bucket
    arrays split evenly over an N-rank mesh. CPU tensors, as the
    builders give them."""
    if multiple <= 1:
        return ell

    def pad_side(side: EllSide) -> EllSide:
        sizes = [int(b.rows.shape[0]) for b in side.buckets]
        padded = [-(-s // multiple) * multiple for s in sizes]
        old_off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        new_off = np.concatenate([[0], np.cumsum(padded)]).astype(np.int64)

        def remap(arr):
            arr = np.asarray(arr).astype(np.int64)
            out = np.full(arr.shape, new_off[-1], dtype=np.int32)  # zero row
            active = np.flatnonzero(arr < old_off[-1])
            pos = arr[active]
            b_of = np.searchsorted(old_off, pos, side="right") - 1
            out[active] = (new_off[b_of] + (pos - old_off[b_of])).astype(np.int32)
            return out

        buckets = []
        for b, s, p in zip(side.buckets, sizes, padded):
            arrays = [_np(t) for t in (b.rows, b.cols, b.w, b.eidx)]
            buckets.append(EllBucket(*(_t(np.concatenate(
                [a, np.zeros((p - s, *a.shape[1:]), a.dtype)])) for a in arrays)))
        return EllSide(
            buckets=tuple(buckets),
            assemble=_t(remap(_np(side.assemble))),
            n_rows=side.n_rows,
            extra_levels=tuple((d, _t(remap(_np(p)))) for d, p in side.extra_levels),
        )

    return dataclasses.replace(ell, by_user=pad_side(ell.by_user), by_item=pad_side(ell.by_item))


# ------------------------------------------------------- sharded layout


@dataclasses.dataclass(frozen=True)
class ShardedEllSide:
    """One SpMM direction, row-partitioned into ``n_shards`` equal slices
    (the JAX package's arrays, element for element).

    Every bucket's rows are split into n_shards contiguous chunks padded
    to equal length (padding slots carry col 0 / weight 0, and no
    assemble entry points at them), stacked shard-major:

    - ``cols``/``w``/``eidx`` (and ``rows``, 0 on padding): tuple over
      buckets of (n_shards · rows_ps_b, width_b) tensors; shard s owns
      rows [s · rows_ps_b, (s + 1) · rows_ps_b).
    - ``assemble``: (n_shards, n_rows). Shard s's row maps every
      destination row it owns to its position in s's local concatenation
      of bucket outputs, and every other row to the local zero row
      (``local_len``). Summing the shards' assembled outputs (a psum over
      the mesh) completes the rows.
    - ``extra_dst``/``extra_pos``: (n_shards, E_max) overflow chunks of
      split rows, routed to the shard that owns the chunk's bucket row;
      padding entries add the local zero row into row 0. None when the
      side has no split row."""

    rows: Tuple[torch.Tensor, ...]
    cols: Tuple[torch.Tensor, ...]
    w: Tuple[torch.Tensor, ...]
    eidx: Tuple[torch.Tensor, ...]
    assemble: torch.Tensor  # (n_shards, n_rows) int32
    n_rows: int
    local_len: int
    n_shards: int
    extra_dst: Optional[torch.Tensor] = None  # (n_shards, E_max) int32
    extra_pos: Optional[torch.Tensor] = None  # (n_shards, E_max) int32

    def local(self, s: int) -> EllSide:
        """Shard ``s``'s part as an `EllSide` over its local buckets: its
        apply is the shard's partial (zeros on rows it does not own), the
        overflow chunks added one chunk level a launch."""
        def part(t):
            return t.view(self.n_shards, -1, *t.shape[1:])[s]

        levels = ()
        if self.extra_dst is not None:
            dst, pos = _np(self.extra_dst[s]), _np(self.extra_pos[s])
            real = pos != self.local_len
            levels = chunk_levels(dst[real], pos[real])
        return EllSide(
            buckets=tuple(EllBucket(*(part(t) for t in b))
                          for b in zip(self.rows, self.cols, self.w, self.eidx)),
            assemble=self.assemble[s],
            n_rows=self.n_rows,
            extra_levels=levels,
        )


@dataclasses.dataclass(frozen=True)
class ShardedEllGraph:
    by_user: ShardedEllSide
    by_item: ShardedEllSide
    n_users: int
    m_items: int

    def local(self, s: int) -> EllGraph:
        """Shard ``s``'s part of both directions: `ell_propagate_layer` on
        it gives the shard's partial rows of a layer, forward and
        backward (the transpose side's shard sums to the same total)."""
        return EllGraph(self.by_user.local(s), self.by_item.local(s), self.n_users,
                        self.m_items)


def _shard_side(side: EllSide, n_shards: int) -> ShardedEllSide:
    """Split each bucket's rows into n_shards padded contiguous chunks and
    build the per-shard assembly gathers."""
    assemble_np = _np(side.assemble)
    sizes = [int(b.rows.shape[0]) for b in side.buckets]
    g_off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    rows_ps = [-(-s // n_shards) for s in sizes]
    l_off = np.concatenate([[0], np.cumsum(rows_ps)]).astype(np.int64)
    local_len = int(l_off[-1])

    arrays = []
    for b, rp in zip(side.buckets, rows_ps):
        pad = n_shards * rp - int(b.rows.shape[0])
        arrays.append(tuple(_t(np.concatenate([a, np.zeros((pad, *a.shape[1:]), a.dtype)]))
                            for a in (_np(t) for t in (b.rows, b.cols, b.w, b.eidx))))

    def owner_and_local(pos):
        """global concat position → (owner shard, local concat position)."""
        bucket_of = np.searchsorted(g_off, pos, side="right") - 1
        within = pos - g_off[bucket_of]
        rp_arr = np.asarray(rows_ps, dtype=np.int64)[bucket_of]
        owner = within // rp_arr
        return owner, l_off[bucket_of] + (within - owner * rp_arr)

    assemble = np.full((n_shards, side.n_rows), local_len, dtype=np.int32)
    active = np.flatnonzero(assemble_np < g_off[-1])
    owner, local_pos = owner_and_local(assemble_np[active].astype(np.int64))
    assemble[owner, active] = local_pos.astype(np.int32)

    extra_dst = extra_pos = None
    extras = flat_extras(side)
    if extras is not None:
        dst, pos = extras
        e_owner, e_local = owner_and_local(pos.astype(np.int64))
        e_max = max(1, int(np.bincount(e_owner, minlength=n_shards).max()))
        extra_dst = np.zeros((n_shards, e_max), dtype=np.int32)
        extra_pos = np.full((n_shards, e_max), local_len, dtype=np.int32)
        for s in range(n_shards):
            mine = np.flatnonzero(e_owner == s)
            extra_dst[s, :mine.size] = dst[mine]
            extra_pos[s, :mine.size] = e_local[mine]
        extra_dst, extra_pos = _t(extra_dst), _t(extra_pos)

    rows, cols, w, eidx = (tuple(a[k] for a in arrays) for k in range(4))
    return ShardedEllSide(rows=rows, cols=cols, w=w, eidx=eidx, assemble=_t(assemble),
                          n_rows=side.n_rows, local_len=local_len, n_shards=n_shards,
                          extra_dst=extra_dst, extra_pos=extra_pos)


def shard_ell_graph(ell: EllGraph, n_shards: int) -> ShardedEllGraph:
    """Re-layout an EllGraph (CPU tensors) for ``n_shards``-way edge
    partitioning: each rank of a mesh stores and computes 1/n_shards of
    every bucket's rows."""
    return ShardedEllGraph(
        by_user=_shard_side(ell.by_user, n_shards),
        by_item=_shard_side(ell.by_item, n_shards),
        n_users=ell.n_users,
        m_items=ell.m_items,
    )


def apply_sharded_side_local(
    side_cols: Sequence[torch.Tensor],
    side_w: Sequence[torch.Tensor],
    side_eidx: Sequence[torch.Tensor],
    assemble_local: torch.Tensor,
    x: torch.Tensor,
    edge_mask: Optional[torch.Tensor] = None,
    extra_dst_local: Optional[torch.Tensor] = None,
    extra_pos_local: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One shard's partial of ``W @ x`` from its local arrays (the JAX
    package's signature): (n_rows, d) with zeros on rows the shard does
    not own; the sum over shards completes the rows. Runs the gather-
    reduce over the shard's buckets as one `BucketTable` and adds its
    overflow chunks one chunk level at a time."""
    local_len = sum(int(c.shape[0]) for c in side_cols)
    levels = ()
    if extra_dst_local is not None:
        dst, pos = _np(extra_dst_local), _np(extra_pos_local)
        real = pos != local_len
        levels = tuple((d.to(x.device), p.to(x.device))
                       for d, p in chunk_levels(dst[real], pos[real]))
    side = EllSide(
        buckets=tuple(EllBucket(c.new_zeros(c.shape[0]), c, w, e)
                      for c, w, e in zip(side_cols, side_w, side_eidx)),
        assemble=assemble_local, n_rows=int(assemble_local.shape[0]), extra_levels=levels)
    if edge_mask is not None:
        edge_mask = edge_mask.detach().float().contiguous()
    return _apply_side(side, x.contiguous(), edge_mask)
