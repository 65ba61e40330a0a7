"""The repository's ``bench.py`` configuration and its data, for the
port's tools and ``chip_smoke.py``.

`bench_config` is ``bench.py``'s measured configuration exactly:
LightGCN, 3 layers, dim 64, bf16 propagation, the tiled layout with
G = 64 groups × C = 2048 hub columns, batch 131072, the device sampler
with ``neg_candidates=4``, Adam as configured by default, no eval. The
data is ``data/gowalla`` when its ``train.txt`` is there, else the
Gowalla-shaped stand-in of `stand_in_data` (never a download). The
benchmark's ``gowalla-train`` cell (``python3 benchmark/run.py``) times
this configuration.
"""

from __future__ import annotations

import os

from gsrs_tpu_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from gsrs_tpu_torch.data.dataset import InteractionData, load_dataset

GROUPS, COLS = 64, 2048
STAND_IN = "synthetic.powerlaw(29858, 40981, avg_degree=27, seed=2020, holdout_frac=0.2)"


def bench_config() -> ExperimentConfig:
    """``bench.py``'s ExperimentConfig, field for field."""
    return ExperimentConfig(
        model=ModelConfig(num_layers=3, embedding_dim=64, bf16_compute=True, spmm_mode="tiled",
                          tiled_groups=GROUPS, tiled_cols=COLS),
        train=TrainConfig(batch_size=131072, tensorboard=False, neg_candidates=4),
    )


def stand_in_data() -> InteractionData:
    """Gowalla's node counts and average degree, power-law degrees, a 20%
    holdout: the training data of ``chip_smoke.py``."""
    from gsrs_tpu_torch.data import synthetic

    return synthetic.powerlaw(29858, 40981, avg_degree=27, seed=2020, holdout_frac=0.2)


def gowalla_or_stand_in(dataset_dir: str):
    """→ (data, label, dataset_dir or None): the dataset in ``dataset_dir``
    (named gowalla) when its train.txt exists, else the stand-in."""
    if os.path.exists(os.path.join(dataset_dir, "train.txt")):
        return load_dataset(dataset_dir, name="gowalla"), "gowalla", dataset_dir
    return stand_in_data(), STAND_IN, None
