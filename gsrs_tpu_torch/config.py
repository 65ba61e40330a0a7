"""Experiment configuration: copies of the dataclasses of `gsrs_tpu.config`.

Every field and default is the JAX package's, so a ``model_meta.json``
written by the JAX trainer loads unchanged with ``ModelConfig(**meta)``
and configs interchange. Fields the port does not run yet are accepted
and checked where they are used (`LightGCN`, `Trainer`, `Evaluator`).
``TrainConfig.fused_adam`` keeps the JAX values: "off" is
`torch.optim.Adam`, "jnp" the plain fused update in PyTorch ops and
"pallas" the hand-written CUDA kernel (`gsrs_tpu_torch.train.fused_adam`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset location and ingestion options."""

    dataset: str = "gowalla"
    data_root: str = dataclasses.field(
        default_factory=lambda: os.path.join(_repo_root(), "data")
    )
    cache_adjacency: bool = True
    edge_pad_multiple: int = 8192

    @property
    def dataset_dir(self) -> str:
        return os.path.join(self.data_root, self.dataset)


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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization and loop hyperparameters (see gsrs_tpu/config.py)."""

    batch_size: int = 2048
    lr: float = 1e-3
    decay: float = 1e-4  # L2 coefficient applied to the BPR reg term
    epochs: int = 1000
    seed: int = 2020
    # MultiStepLR, step-indexed: milestone epoch × steps per epoch
    use_scheduler: bool = False
    sched_milestones: Tuple[int, ...] = (120, 240, 360, 480)
    sched_gamma: float = 0.5
    # checkpoints and logging (Trainer.fit)
    checkpoint_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(_repo_root(), "checkpoints")
    )
    save_every: int = 10
    keep_topk: int = 0
    resume: bool = False
    resume_path: Optional[str] = None
    load_pretrained: bool = False
    pretrain: int = 0
    eval_every: int = 10
    early_stop_evals: int = 0
    tensorboard: bool = True
    comment: str = "lgn"
    # steps per sampled chunk of an epoch: 0 = whole epoch capped at 128,
    # -1 = the whole epoch in one chunk
    steps_per_scan: int = 0
    # negative candidates per triplet of the device sampler (0 = unchecked)
    neg_candidates: int = 16
    save_last_every: int = 1
    # "off" | "jnp" | "pallas"
    fused_adam: str = "off"


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Evaluation options (see gsrs_tpu/config.py)."""

    test_batch: int = 2048
    topks: Tuple[int, ...] = (20,)
    multicore: bool = False  # accepted for parity; metrics are vectorized
    # "exact" | "approx" | "threshold" (gsrs_tpu_torch.ops.topk)
    topk_method: str = "exact"
    topk_recall_target: float = 0.98
    # True/"on" scores in the bit-plane layout (K2); "auto"/"off" in
    # natural order (K1), as in gsrs_tpu_torch.ops.scoring
    use_pallas_scoring: object = "auto"
    pallas_variant: str = "bitplane"
    pallas_auto_min_items: int = 65536


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Mesh layout: data_axis × model_axis ranks (`gsrs_tpu_torch.parallel`)."""

    data_axis: int = 1
    model_axis: int = 1
    axis_names: Tuple[str, str] = ("data", "model")
    use_shard_map: bool = True


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)

    def replace(self, **sections) -> "ExperimentConfig":
        return dataclasses.replace(self, **sections)


def topks_from_string(s: str) -> Tuple[int, ...]:
    """Parse "[20]"-style topks strings."""
    import ast

    v = ast.literal_eval(s)
    if isinstance(v, int):
        return (v,)
    return tuple(int(x) for x in v)


def milestones_from_string(s: str) -> Tuple[int, ...]:
    """Parse "[120,240]" or "120,240"."""
    import ast

    s = s.strip()
    try:
        v = ast.literal_eval(s)
        if isinstance(v, int):
            return (v,)
        return tuple(int(x) for x in v)
    except (ValueError, SyntaxError):
        return tuple(int(x) for x in s.strip("[]").split(",") if x.strip())
