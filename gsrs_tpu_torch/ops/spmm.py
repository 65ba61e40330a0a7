"""Edge dropout mask (port of `gsrs_tpu.ops.spmm.edge_keep_mask`).

The rest of `gsrs_tpu.ops.spmm` (the segment-sum path) is not ported yet
(ROADMAP.md A3)."""

from __future__ import annotations

from typing import Optional

import torch


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
