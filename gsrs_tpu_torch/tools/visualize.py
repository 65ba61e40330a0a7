"""Training curves and the pop gate (port of ``tools/visualize.py``).

    python -m gsrs_tpu_torch.tools.visualize curves --checkpoint_dir CK [--out curves.png]
    python -m gsrs_tpu_torch.tools.visualize gates --checkpoint_dir CK --dataset_dir DS \\
        [--out gates.png] [--device cuda:0]

Each subcommand is a function that computes and one that draws; only
the drawing imports matplotlib (and nothing here needs pandas), so the
values are computed wherever the port runs and drawn where matplotlib
is installed:

- `curve_series`: the loss, lr and metric columns of the two CSVs that
  the trainers write;
- `gate_values`: the pop gate of every item, and log1p of its degree,
  from the newest checkpoint of a pop-gate run restored into the model
  that ``model_meta.json`` describes (its training layout and i2i
  graph: the gates the trained model produces), through
  `LightGCN.final_embeddings` on the device (K4 propagates).
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np


def _column(rows: List[dict], key: str) -> List[float]:
    return [float(r[key]) if r.get(key) not in (None, "") else math.nan for r in rows]


def curve_series(checkpoint_dir: str) -> Dict[str, Dict[str, List[float]]]:
    """{"train": {"epoch", "train_loss", "lr"}, "valid": {"epoch", and
    each recall@/ndcg@/precision@ column}}: one value a CSV row (an empty
    cell, as the sequential trainer leaves ``lr``, is NaN); a missing CSV
    gives an empty section."""
    out: Dict[str, Dict[str, List[float]]] = {"train": {}, "valid": {}}
    for section, name in (("train", "train_epoch_metrics.csv"),
                          ("valid", "valid_epoch_metrics.csv")):
        path = os.path.join(checkpoint_dir, name)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            rows = list(csv.DictReader(f))
        keys = (["epoch", "train_loss", "lr"] if section == "train" else
                ["epoch"] + [k for k in (rows[0] if rows else {})
                             if k.startswith(("recall@", "ndcg@", "precision@"))])
        out[section] = {k: _column(rows, k) for k in keys}
    return out


def gate_values(checkpoint_dir: str, dataset_dir: str,
                device=None) -> Tuple[np.ndarray, np.ndarray]:
    """→ (the gate of each item (m,), log1p of each item's degree (m,)),
    float32 and float64 numpy, on ``device`` (default ``cuda:0``)."""
    import torch

    from gsrs_tpu_torch.cli import layout_from_interactions, load_i2i
    from gsrs_tpu_torch.config import ModelConfig
    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.data.dataset import load_dataset
    from gsrs_tpu_torch.device import resolve_device
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.serve import model_config_from_meta
    from gsrs_tpu_torch.train.checkpoint import CheckpointManager

    device = resolve_device(device)
    data = load_dataset(dataset_dir)
    graph = build_graph(data, cache_dir=dataset_dir)
    # the hyperparameters the trainer wrote: defaults (3 layers, temperature
    # 1) would give gates the trained model never produces
    meta_path = os.path.join(checkpoint_dir, "model_meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            cfg = model_config_from_meta(json.load(f))
        if not cfg.use_pop_gate:
            raise SystemExit(f"{meta_path} says this checkpoint was trained without the pop "
                             "gate: nothing to plot")
    else:
        cfg = ModelConfig(use_pop_gate=True)
    i2i = None
    if cfg.use_item_item and cfg.i2i_path:
        i2i = load_i2i(cfg.i2i_path)
        if i2i is None:
            raise SystemExit(f"the model was trained with the i2i graph {cfg.i2i_path}, which "
                             "cannot be read")
    model = build_model(cfg, graph, i2i, layout_from_interactions(cfg, data), device=device,
                        cache_dir=dataset_dir)
    mgr = CheckpointManager(checkpoint_dir)
    path = mgr.resolve_resume_path(None)
    if path is None:
        raise SystemExit(f"no checkpoint found under {checkpoint_dir}")
    model.load_state_dict(mgr.restore(path)["params"])
    with torch.no_grad():
        _, _, gate = model.final_embeddings()
    pop = np.log1p(np.asarray(data.item_degrees, dtype=np.float64))
    return gate.float().cpu().numpy(), pop


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_training_curves(checkpoint_dir: str, out: str) -> None:
    plt = _pyplot()
    series = curve_series(checkpoint_dir)
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    train, valid = series["train"], series["valid"]
    if train:
        axes[0].plot(train["epoch"], train["train_loss"])
        axes[0].set_title("BPR train loss")
        axes[0].set_xlabel("epoch")
        axes[1].plot(train["epoch"], train["lr"])
        axes[1].set_title("learning rate")
        axes[1].set_xlabel("epoch")
    if valid:
        for col, values in valid.items():
            if col != "epoch":
                axes[2].plot(valid["epoch"], values, label=col)
        axes[2].set_title("eval metrics")
        axes[2].set_xlabel("epoch")
        axes[2].legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    print(f"wrote {out}")


def plot_gate_distribution(checkpoint_dir: str, dataset_dir: str, out: str,
                           device=None) -> None:
    gate, pop = gate_values(checkpoint_dir, dataset_dir, device)
    plt = _pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].hist(gate, bins=50)
    axes[0].set_title("pop-gate value distribution")
    axes[0].set_xlabel("gate (1 = keep graph emb)")
    axes[1].scatter(pop, gate, s=2, alpha=0.3)
    axes[1].set_title("gate vs log1p(popularity)")
    axes[1].set_xlabel("log1p(item degree)")
    axes[1].set_ylabel("gate")
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    print(f"wrote {out}")


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(prog="gsrs_tpu_torch.tools.visualize")
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("curves")
    c.add_argument("--checkpoint_dir", required=True)
    c.add_argument("--out", default="curves.png")
    g = sub.add_parser("gates")
    g.add_argument("--checkpoint_dir", required=True)
    g.add_argument("--dataset_dir", required=True)
    g.add_argument("--out", default="gates.png")
    g.add_argument("--device", default=None, help="torch device (default cuda:0)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.cmd == "curves":
        plot_training_curves(args.checkpoint_dir, args.out)
    else:
        plot_gate_distribution(args.checkpoint_dir, args.dataset_dir, args.out, args.device)


if __name__ == "__main__":
    main()
