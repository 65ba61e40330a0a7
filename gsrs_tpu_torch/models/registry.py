"""Model registry (port of `gsrs_tpu.models.registry`)."""

from __future__ import annotations

from typing import Optional, Union

import torch

from gsrs_tpu_torch.config import ModelConfig
from gsrs_tpu_torch.data.adjacency import BipartiteGraph
from gsrs_tpu_torch.device import DeviceLike
from gsrs_tpu_torch.models.lightgcn import ItemItemGraph, LightGCN
from gsrs_tpu_torch.ops.ell import EllGraph
from gsrs_tpu_torch.ops.tiled import TiledGraph

MODELS = {"lgn": LightGCN}
# registered in the JAX package, ported with the graph zoo (ROADMAP.md A5)
NOT_PORTED = ("mf", "ngcf", "xsimgcl", "ultragcn")


def build_model(
    cfg: ModelConfig,
    graph: BipartiteGraph,
    i2i: Optional[ItemItemGraph] = None,
    ell: Union[EllGraph, TiledGraph, None] = None,
    device: DeviceLike = None,
    generator: Optional[torch.Generator] = None,
) -> LightGCN:
    """Build the configured model on ``device`` (default ``cuda:0``);
    ``i2i`` and ``ell`` as in the JAX package's `build_model`."""
    if cfg.model in NOT_PORTED:
        raise NotImplementedError(
            f"model '{cfg.model}' is not ported yet (ROADMAP.md A5, graph zoo)"
        )
    if cfg.model not in MODELS:
        raise ValueError(
            f"model '{cfg.model}' is not registered; available: {sorted(MODELS)}"
        )
    return MODELS[cfg.model](cfg, graph, i2i=i2i, ell=ell, device=device, generator=generator)
