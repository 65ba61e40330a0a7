"""Whole-epoch time across the propagation layouts (port of
``tools/bench_spmm_modes.py``).

    python -m gsrs_tpu_torch.tools.bench_spmm_modes [--dataset_dir DS] [--batch 2048 8192] \\
        [--hybrid_cols 8192 16384] [--tiled 64:2048] [--no_ell] [--timed_epochs 2]

LightGCN, 3 layers, dim 64, bf16, no eval: a warm-up epoch, then
``--timed_epochs`` epochs on the host clock (each ends by reading its
mean loss), on-device sampling included, as ``bench.py`` times it, for
``ell`` (K4 on both sides), ``hybrid<C>`` (dense hub blocks + a residual
ELL) and ``tiled G:C`` (per-group hub blocks + a residual ELL). Data:
``--dataset_dir`` (default ``data/gowalla``), or the Gowalla-shaped
stand-in of `gsrs_tpu_torch.bench` where it holds no train.txt. Each row
prints the JAX tool's keys and the kernels' launches over its epochs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

BASELINE_EPOCH_SECONDS = 33.5  # the reference's published seconds an epoch on Gowalla


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="gsrs_tpu_torch.tools.bench_spmm_modes")
    ap.add_argument("--batch", type=int, nargs="+", default=[2048, 8192])
    ap.add_argument("--hybrid_cols", type=int, nargs="*", default=[8192, 16384],
                    help="hybrid variants; pass with no values to skip hybrid")
    ap.add_argument("--no_ell", action="store_true", help="skip the ELL baseline arm")
    ap.add_argument("--tiled", type=str, nargs="*", default=[],
                    help="tiled variants as G:C pairs, e.g. --tiled 32:4096 64:4096")
    ap.add_argument("--timed_epochs", type=int, default=2)
    ap.add_argument("--dataset_dir", default="data/gowalla",
                    help="the Gowalla-shaped stand-in where it has no train.txt")
    ap.add_argument("--device", default=None, help="torch device (default cuda:0)")
    return ap


def main(argv: Optional[list] = None) -> list:
    """→ the rows printed."""
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)

    import torch

    from gsrs_tpu_torch.bench import gowalla_or_stand_in
    from gsrs_tpu_torch.config import ExperimentConfig, ModelConfig, TrainConfig
    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.device import resolve_device
    from gsrs_tpu_torch.kernels import launch_counts, launches_since
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.ops.ell import ell_from_interactions
    from gsrs_tpu_torch.ops.hybrid import hybrid_from_interactions
    from gsrs_tpu_torch.ops.tiled import tiled_from_interactions
    from gsrs_tpu_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    data, label, cache_dir = gowalla_or_stand_in(args.dataset_dir)
    print(f"[data] {label}")
    graph = build_graph(data, cache_dir=cache_dir)

    layouts = []
    if not args.no_ell:
        layouts.append(("ell", "ell", {}, ell_from_interactions(data)))
    for c in args.hybrid_cols:
        layouts.append((f"hybrid{c}", "hybrid", {"hybrid_cols": c},
                        hybrid_from_interactions(data, cols=c, dtype=torch.bfloat16)))
    for gc in args.tiled:
        g, c = (int(v) for v in gc.split(":"))
        layouts.append((f"tiledG{g}C{c}", "tiled", {"tiled_groups": g, "tiled_cols": c},
                        tiled_from_interactions(data, groups=g, cols=c, dtype=torch.bfloat16)))

    rows = []
    for label, mode, extra, layout in layouts:
        mcfg = ModelConfig(num_layers=3, embedding_dim=64, bf16_compute=True, spmm_mode=mode,
                           **extra)
        for B in args.batch:
            cfg = ExperimentConfig(model=mcfg, train=TrainConfig(batch_size=B, tensorboard=False))
            model = build_model(mcfg, graph, ell=layout, device=device)
            trainer = Trainer(cfg, data, graph, model, run_eval=False, device=device)
            state = trainer.init_state()
            before = launch_counts()
            state, _ = trainer.train_epoch(state)  # warm-up
            t0 = time.time()
            for _ in range(args.timed_epochs):
                state, loss = trainer.train_epoch(state)  # reads the loss: ends synchronized
            dt = (time.time() - t0) / args.timed_epochs
            rows.append({
                "spmm": label, "batch": B,
                "epoch_s": round(dt, 3),
                "vs_reference_33.5s": round(BASELINE_EPOCH_SECONDS / dt, 2),
                "last_loss": round(float(loss), 5),
                "launches": launches_since(before),
            })
            print(json.dumps(rows[-1]), flush=True)
            del trainer, state, model
    return rows


if __name__ == "__main__":
    main()
