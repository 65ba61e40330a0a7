"""Model configuration: a copy of `gsrs_tpu.config.ModelConfig`.

Every field and default is the JAX package's, so a ``model_meta.json``
written by the JAX trainer loads unchanged with ``ModelConfig(**meta)``.
Fields the port does not run yet are accepted and checked where a model
is built (`gsrs_tpu_torch.models.lightgcn.LightGCN`)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """LightGCN model family hyperparameters (see gsrs_tpu/config.py for
    each field's provenance in the reference implementation)."""

    model: str = "lgn"
    embedding_dim: int = 64
    num_layers: int = 3
    # edge dropout on the propagation graph (training only)
    dropout: bool = False
    keep_prob: float = 0.6
    # accepted for CLI parity, ignored
    a_split: bool = False
    a_fold: int = 100
    # what the BPR L2 term regularizes: 'propagated' | 'ego'
    reg_mode: str = "propagated"

    # popularity-gate fusion
    use_pop_gate: bool = False
    pop_hidden: int = 32
    gate_hidden: int = 64
    gate_entropy_coeff: float = 1e-4
    pop_gate_temp: float = 1.0

    # item-item co-occurrence graph fusion
    use_item_item: bool = False
    i2i_path: Optional[str] = None
    i2i_alpha: float = 0.1

    # personalised-PageRank layer weights: accepted for parity, ignored
    use_ppr_weights: bool = False
    ppr_weights_path: Optional[str] = None
    exp_smooth_beta: float = 0.0

    # XSimGCL contrastive settings (model='xsimgcl')
    cl_lambda: float = 0.2
    cl_temp: float = 0.2
    cl_eps: float = 0.2
    cl_layer: int = 1

    # UltraGCN settings (model='ultragcn')
    ug_neg_num: int = 1500
    ug_neg_weight: float = 300.0
    ug_w1: float = 1e-6
    ug_w2: float = 1.0
    ug_w3: float = 1e-6
    ug_w4: float = 1.0
    ug_lambda: float = 2.75
    ug_ii_k: int = 10
    ug_init_std: float = 1e-4
    ug_neg_sharing: str = "none"
    ug_neg_groups: int = 8
    ug_neg_pool: int = 8192
    ug_sift_pos: bool = False

    # propagation in bf16 (embeddings stay fp32)
    bf16_compute: bool = False

    # propagation layout: 'ell' | 'hybrid' | 'tiled' | 'segment'
    spmm_mode: str = "ell"
    hybrid_cols: int = 8192
    tiled_groups: int = 32
    tiled_cols: int = 4096
