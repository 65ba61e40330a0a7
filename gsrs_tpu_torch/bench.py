"""LightGCN epoch time on one CUDA card: the port's counterpart of the
repository's ``bench.py``.

    python -m gsrs_tpu_torch.bench            # from the repository root; needs a CUDA card

Builds ``bench.py``'s measured configuration exactly: LightGCN, 3 layers,
dim 64, bf16 propagation, the tiled layout with G = 64 groups × C = 2048
hub columns (`tiled_from_interactions`, bf16 dense blocks), batch 131072,
the device sampler with ``neg_candidates=4``, Adam as configured by
default, no eval. One warm-up epoch, then ``N_TIMED_EPOCHS`` epochs on the
host clock; each epoch ends by reading its mean loss, so the time ends
synchronized. Sampling is part of the epoch, as there.

Data: ``data/gowalla`` when ``train.txt`` is there, else the
Gowalla-shaped stand-in of `stand_in_data` (never a download). Prints one
JSON line with ``bench.py``'s keys (``metric``, ``value``, ``unit``,
``vs_baseline``) plus ``data`` and ``device``. ``vs_baseline`` (the
reference's published 33.5 s/epoch over ours) compares real Gowalla only
and is null on the stand-in.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from gsrs_tpu_torch.config import ExperimentConfig, ModelConfig, TrainConfig, _repo_root
from gsrs_tpu_torch.data.adjacency import build_graph
from gsrs_tpu_torch.data.dataset import InteractionData, load_dataset
from gsrs_tpu_torch.device import DeviceLike, resolve_device
from gsrs_tpu_torch.models.registry import build_model
from gsrs_tpu_torch.ops.tiled import tiled_from_interactions
from gsrs_tpu_torch.train.trainer import Trainer

BASELINE_EPOCH_SECONDS = 33.5
N_TIMED_EPOCHS = 3
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


def load_bench_data(data_root: Optional[str] = None):
    """→ (data, label, dataset_dir or None): Gowalla when
    ``<data_root>/gowalla/train.txt`` exists, else the stand-in."""
    return gowalla_or_stand_in(os.path.join(data_root or os.path.join(_repo_root(), "data"),
                                            "gowalla"))


def gowalla_or_stand_in(dataset_dir: str):
    """→ (data, label, dataset_dir or None): the dataset in ``dataset_dir``
    (named gowalla) when its train.txt exists, else the stand-in."""
    if os.path.exists(os.path.join(dataset_dir, "train.txt")):
        return load_dataset(dataset_dir, name="gowalla"), "gowalla", dataset_dir
    return stand_in_data(), STAND_IN, None


def run_bench(
    device: DeviceLike = None,
    data: Optional[InteractionData] = None,
    cfg: Optional[ExperimentConfig] = None,
    epochs: int = N_TIMED_EPOCHS,
    cache_dir: Optional[str] = None,
) -> Dict[str, object]:
    """Builds and trains ``cfg`` (default `bench_config`) on ``data``
    (default the stand-in) → {"epoch_s": mean seconds of the timed
    epochs, "losses": their mean losses, "warmup_s", "build_s" (graph and
    layout on the host), "steps_per_epoch", "trainer", "state"}."""
    device = resolve_device(device)
    data = stand_in_data() if data is None else data
    cfg = bench_config() if cfg is None else cfg
    m = cfg.model
    t0 = time.perf_counter()
    graph = build_graph(data, cache_dir=cache_dir)
    layout = tiled_from_interactions(
        data, groups=m.tiled_groups, cols=m.tiled_cols,
        dtype=torch.bfloat16 if m.bf16_compute else torch.float32,
    )
    build_s = time.perf_counter() - t0
    model = build_model(m, graph, ell=layout, device=device)
    trainer = Trainer(cfg, data, graph, model, run_eval=False, device=device)
    state = trainer.init_state()
    t0 = time.perf_counter()
    state, _ = trainer.train_epoch(state)  # warm-up: builds K4's launch tables
    warmup_s = time.perf_counter() - t0
    losses = []
    t0 = time.perf_counter()
    for _ in range(epochs):
        state, loss = trainer.train_epoch(state)  # reads the loss: ends synchronized
        losses.append(loss)
    epoch_s = (time.perf_counter() - t0) / epochs
    return dict(epoch_s=epoch_s, losses=losses, warmup_s=warmup_s, build_s=build_s,
                steps_per_epoch=trainer.steps_per_epoch, trainer=trainer, state=state)


def main(argv: Optional[list] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(prog="gsrs_tpu_torch.bench")
    ap.add_argument("--device", default=None, help="torch device (default cuda:0)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    data, label, ddir = load_bench_data()
    out = run_bench(device, data, cache_dir=ddir)
    if not all(np.isfinite(out["losses"])):
        raise SystemExit(f"non-finite epoch losses {out['losses']}")
    s = out["epoch_s"]
    print(json.dumps({
        "metric": "gowalla_epoch_time",
        "value": round(s, 3),
        "unit": "s/epoch",
        "vs_baseline": round(BASELINE_EPOCH_SECONDS / s, 3) if label == "gowalla" else None,
        "data": label,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else str(device)),
    }))


if __name__ == "__main__":
    main()
