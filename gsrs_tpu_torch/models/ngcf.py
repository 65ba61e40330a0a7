"""NGCF, Neural Graph Collaborative Filtering (port of
`gsrs_tpu.models.ngcf`).

The layer

    e_u' = LeakyReLU( (e_u + Σ_i ŵ_ui e_i) W1 + b1 + ((Σ_i ŵ_ui e_i) ⊙ e_u) W2 + b2 )

uses Σ_i ŵ_ui (e_i ⊙ e_u) = (Σ_i ŵ_ui e_i) ⊙ e_u, so each layer is one
propagation layer of the model's layout (ELL through the gather-reduce
kernel, tiled, hybrid or segment, with LightGCN's dropout) and two dense
products. The per-layer W1, W2 (d, d) and b1, b2 (d,) are parameters
named as the JAX package's (``ngcf_w1_0``, ...), applied as ``x @ W``,
so JAX parameters load untransposed.

Readout: the L2-normalized layers 0..K concatenated, a scoring width of
d·(K+1). The pop gate and i2i smoothing assume a d-wide item readout and
are off; ``reg_mode`` is pinned to ``"ego"``: the readout rows all have
squared norm K+1, so the propagated L2 term would have no gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gsrs_tpu_torch.models.lightgcn import LightGCN
from gsrs_tpu_torch.ops.linalg import l2_normalize


class NGCF(LightGCN):
    def __init__(self, cfg, graph, i2i=None, ell=None, device=None, generator=None):
        cfg = dataclasses.replace(cfg, use_pop_gate=False, use_item_item=False, reg_mode="ego")
        super().__init__(cfg, graph, i2i=None, ell=ell, device=device, generator=generator)

    def _add_parameters(self, device: torch.device) -> None:
        d = self.cfg.embedding_dim
        for k in range(self.cfg.num_layers):
            for name, shape in (("w1", (d, d)), ("w2", (d, d)), ("b1", (d,)), ("b2", (d,))):
                self.register_parameter(f"ngcf_{name}_{k}",
                                        nn.Parameter(torch.empty(shape, device=device)))

    @torch.no_grad()
    def init_params(self, generator: Optional[torch.Generator] = None) -> None:
        """LightGCN's embeddings, then per layer W1 and W2 Glorot-normal
        (std sqrt(2/(d+d))) and zero biases, drawn on the host from
        ``generator``."""
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        super().init_params(g)
        d = self.cfg.embedding_dim
        glorot = float(np.sqrt(2.0 / (d + d)))
        for k in range(self.cfg.num_layers):
            for name in ("w1", "w2"):
                getattr(self, f"ngcf_{name}_{k}").copy_(glorot * torch.randn(d, d, generator=g))
            for name in ("b1", "b2"):
                getattr(self, f"ngcf_{name}_{k}").zero_()

    def propagate(
        self, dropout_generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """K NGCF layers in the compute dtype → the fp32 concatenation of
        the L2-normalized layers 0..K, (n, d·(K+1)) and (m, d·(K+1))."""
        u, i = self._tables()
        dtype = u.dtype
        layer = self._layer(dropout_generator, dtype)
        outs_u, outs_i = [l2_normalize(u.float())], [l2_normalize(i.float())]
        cur_u, cur_i = u, i
        for k in range(self.cfg.num_layers):
            agg_u, agg_i = layer(cur_u, cur_i)
            w1, w2, b1, b2 = (getattr(self, f"ngcf_{n}_{k}").to(dtype)
                              for n in ("w1", "w2", "b1", "b2"))
            cur_u = F.leaky_relu((cur_u + agg_u) @ w1 + b1 + (agg_u * cur_u) @ w2 + b2, 0.2)
            cur_i = F.leaky_relu((cur_i + agg_i) @ w1 + b1 + (agg_i * cur_i) @ w2 + b2, 0.2)
            outs_u.append(l2_normalize(cur_u.float()))
            outs_i.append(l2_normalize(cur_i.float()))
        return torch.cat(outs_u, dim=1), torch.cat(outs_i, dim=1)
