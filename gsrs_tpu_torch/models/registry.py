"""Model registry (port of `gsrs_tpu.models.registry`)."""

from __future__ import annotations

from typing import Optional

import torch

from gsrs_tpu_torch.config import ModelConfig
from gsrs_tpu_torch.data.adjacency import BipartiteGraph
from gsrs_tpu_torch.device import DeviceLike
from gsrs_tpu_torch.models.lightgcn import ItemItemGraph, Layout, LightGCN
from gsrs_tpu_torch.models.mf import PureMF
from gsrs_tpu_torch.models.ngcf import NGCF
from gsrs_tpu_torch.models.ultragcn import UltraGCN
from gsrs_tpu_torch.models.xsimgcl import XSimGCL

MODELS = {
    "lgn": LightGCN,
    "mf": PureMF,
    "ngcf": NGCF,
    "xsimgcl": XSimGCL,
    "ultragcn": UltraGCN,
}


def build_model(
    cfg: ModelConfig,
    graph: BipartiteGraph,
    i2i: Optional[ItemItemGraph] = None,
    ell: Optional[Layout] = None,
    device: DeviceLike = None,
    generator: Optional[torch.Generator] = None,
    cache_dir: Optional[str] = None,
) -> LightGCN:
    """Build the configured model on ``device`` (default ``cuda:0``);
    ``i2i`` and ``ell`` as in the JAX package's `build_model`.
    ``cache_dir`` (the dataset directory) holds UltraGCN's item–item top-K
    cache."""
    if cfg.model not in MODELS:
        raise ValueError(
            f"model '{cfg.model}' is not registered; available: {sorted(MODELS)}"
        )
    kw = dict(i2i=i2i, ell=ell, device=device, generator=generator)
    if cfg.model == "ultragcn":
        return UltraGCN(cfg, graph, ii_cache_dir=cache_dir, **kw)
    return MODELS[cfg.model](cfg, graph, **kw)
