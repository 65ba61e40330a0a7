"""Edge-list products, the segment layer and the edge dropout mask
(port of `gsrs_tpu.ops.spmm`).

`spmm_edges` is the plain gather + segment-sum product over padded edge
lists; the port runs the item-item smoothing through the ELL
gather-reduce (`gsrs_tpu_torch.ops.ell.ell_spmm`) and keeps this as its
plain version.

The segment layout (``spmm_mode="segment"``) is the ELL layout. JAX sums
the graph's destination-sorted edge arrays with `jax.ops.segment_sum`;
the ELL sides hold the same edges in the same stable by-destination
order, so K4 (the ELL gather-reduce) computes the same function: fp32
sums in slot order, rounded once to the compute dtype, bitwise
repeatable, with a scatter-free backward. A canonical edge mask read
through each slot's ``eidx`` drops exactly the edges that JAX's
sort-order masks drop, so the models run the segment layout as
`ell_propagate_layer` with `edge_keep_mask`. `torch.segment_reduce`, the
library counterpart, took 40× the ELL layer's time on the card
(PERF.md). `propagate_layer` keeps JAX's interface, the masks in both
sort orders (`make_edge_dropout_masks`), over that layer.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gsrs_tpu_torch.ops.ell import EllGraph, ell_from_graph, ell_propagate_layer

MaskPair = Tuple[torch.Tensor, torch.Tensor]  # an edge mask in by-user and by-item order


def spmm_edges(
    seg_ids: torch.Tensor,
    src_ids: torch.Tensor,
    weights: torch.Tensor,
    x: torch.Tensor,
    num_segments: int,
) -> torch.Tensor:
    """out[r] = Σ_{e: seg_ids[e]==r} weights[e] · x[src_ids[e]]; the
    weights are cast to x's dtype first, as in the JAX package."""
    gathered = x.index_select(0, src_ids.long()) * weights.to(x.dtype)[:, None]
    out = x.new_zeros(num_segments, x.shape[-1])
    return out.index_add_(0, seg_ids.long(), gathered)


def propagate_layer(
    graph,
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    edge_mask: Optional[MaskPair] = None,
    ell: Optional[EllGraph] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's segment layer on a `BipartiteGraph`: new_user = W @ item_emb,
    new_item = Wᵀ @ user_emb, through `ell_propagate_layer` on ``ell``
    (default: `ell_from_graph(graph)` on user_emb's device).
    ``edge_mask``: (mask_by_u, mask_by_i) as `make_edge_dropout_masks`
    gives them; mask_by_u goes back to canonical order through
    ``perm_by_u`` (a permutation, so a plain store)."""
    if ell is None:
        ell = ell_from_graph(graph).to(user_emb.device)
    keep = None
    if edge_mask is not None:
        by_u = edge_mask[0]
        keep = torch.empty_like(by_u)
        keep[torch.from_numpy(graph.perm_by_u).to(by_u.device).long()] = by_u
    return ell_propagate_layer(ell, user_emb, item_emb, keep)


def edge_keep_mask(
    generator: torch.Generator,
    graph,
    keep_prob: float,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """One Bernoulli(keep_prob)/keep_prob decision per padded edge in
    CANONICAL order (inverted dropout), on the generator's device. The
    ELL sides index it through their ``eidx``, so both directions drop
    the same edges. The stream differs from JAX's for the same seed."""
    dtype = torch.float32 if dtype is None else dtype
    n = int(graph.perm_by_u.shape[0])
    keep = torch.rand(n, generator=generator, device=generator.device) < keep_prob
    return keep.to(dtype) / keep_prob


def make_edge_dropout_masks(
    generator: torch.Generator,
    graph,
    keep_prob: float,
    dtype: Optional[torch.dtype] = None,
) -> MaskPair:
    """`edge_keep_mask` in both sort orders of the `BipartiteGraph`: the
    same edges drop in both directions."""
    keep = edge_keep_mask(generator, graph, keep_prob, dtype)
    return tuple(keep.index_select(0, torch.from_numpy(p).to(keep.device).long())
                 for p in (graph.perm_by_u, graph.perm_by_i))
