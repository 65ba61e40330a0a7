"""Pure matrix factorization (port of `gsrs_tpu.models.mf`): BPR-trained
embedding dot products with no propagation, LightGCN with zero layers,
no i2i smoothing and no dropout, sharing every path downstream."""

from __future__ import annotations

import dataclasses

from gsrs_tpu_torch.models.lightgcn import LightGCN


class PureMF(LightGCN):
    def __init__(self, cfg, graph, i2i=None, ell=None, device=None, generator=None):
        cfg = dataclasses.replace(cfg, num_layers=0, use_item_item=False, dropout=False)
        super().__init__(cfg, graph, i2i=None, ell=None, device=device, generator=generator)
