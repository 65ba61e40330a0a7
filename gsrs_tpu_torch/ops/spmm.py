"""Edge-list products and the edge dropout mask (port of
`gsrs_tpu.ops.spmm`).

`spmm_edges` is the plain gather + segment-sum product over padded edge
lists; the port runs the item-item smoothing through the ELL
gather-reduce (`gsrs_tpu_torch.ops.ell.ell_spmm`) and keeps this as its
plain version. The segment-sum propagation layer (``spmm_mode=
"segment"``) is ROADMAP.md A3."""

from __future__ import annotations

from typing import Optional

import torch


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
    n = int(graph.edge_w_by_u.shape[0])
    keep = torch.rand(n, generator=generator, device=generator.device) < keep_prob
    return keep.to(dtype) / keep_prob
