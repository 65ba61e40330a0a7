"""Short-horizon hyperparameter sweep of XSimGCL (port of
``tools/sweep_xsimgcl.py``).

    python -m gsrs_tpu_torch.tools.sweep_xsimgcl --dataset gowalla --epochs 75 \\
        --lambdas 0.05 0.1 0.2 [--eps 0.2] [--batch 8192] [--bf16] [--device cuda:0]

Each (cl_lambda, cl_eps) of the grid trains XSimGCL from ``Trainer.init_state``
for ``--epochs`` epochs with an eval every ``--eval_every`` epochs and at
the last, printing the JAX tool's lines (``=== cl_lambda=… cl_eps=… ===``,
``  e{epoch} loss=… k=v …``, ``  ({seconds}s)``). Data:
``<data_root>/<dataset>`` (default ``data/`` in the repository), or the
Gowalla-shaped stand-in of `gsrs_tpu_torch.bench` where it holds no
train.txt. Nothing is saved; the configuration names a checkpoint
directory ``<checkpoint_root>/sweep_l{lam}_e{eps}`` as the JAX tool does.
The ELL kernel (K4) runs in every propagation and the masked-scoring
kernel (K1) scores every eval batch.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="gsrs_tpu_torch.tools.sweep_xsimgcl")
    ap.add_argument("--dataset", default="gowalla")
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--epochs", type=int, default=75)
    ap.add_argument("--eval_every", type=int, default=25)
    ap.add_argument("--lambdas", type=float, nargs="+", default=[0.05, 0.1, 0.2])
    ap.add_argument("--eps", type=float, nargs="+", default=[0.2])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--layer", type=int, default=3)
    ap.add_argument("--recdim", type=int, default=64)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--checkpoint_root", default="/tmp",
                    help="where each configuration's checkpoint directory is named")
    ap.add_argument("--device", default=None, help="torch device (default cuda:0)")
    return ap


def main(argv: Optional[list] = None) -> dict:
    """→ {(lam, eps): [{"epoch", "loss", "elapsed_s" (since the
    configuration's first epoch), **metrics} at each eval]}."""
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)

    from gsrs_tpu_torch.bench import STAND_IN, stand_in_data
    from gsrs_tpu_torch.config import (
        EvalConfig, ExperimentConfig, ModelConfig, TrainConfig, _repo_root,
    )
    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.data.dataset import load_dataset
    from gsrs_tpu_torch.device import resolve_device
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.ops.ell import ell_from_interactions
    from gsrs_tpu_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    ddir = os.path.join(args.data_root or os.path.join(_repo_root(), "data"), args.dataset)
    if os.path.exists(os.path.join(ddir, "train.txt")):
        data, cache_dir = load_dataset(ddir, name=args.dataset), ddir
    else:
        data, cache_dir = stand_in_data(), None
        print(f"[data] {ddir} has no train.txt: {STAND_IN}")
    graph = build_graph(data, cache_dir=cache_dir)
    ell = ell_from_interactions(data)

    trajectories = {}
    for lam in args.lambdas:
        for eps in args.eps:
            cfg = ExperimentConfig(
                model=ModelConfig(
                    model="xsimgcl",
                    num_layers=args.layer,
                    embedding_dim=args.recdim,
                    bf16_compute=args.bf16,
                    cl_lambda=lam,
                    cl_eps=eps,
                ),
                train=TrainConfig(
                    batch_size=args.batch, tensorboard=False,
                    checkpoint_dir=os.path.join(args.checkpoint_root, f"sweep_l{lam}_e{eps}"),
                ),
                eval=EvalConfig(test_batch=2048, topks=(20,)),
            )
            model = build_model(cfg.model, graph, ell=ell, device=device)
            trainer = Trainer(cfg, data, graph, model, device=device)
            state = trainer.init_state()
            print(f"=== cl_lambda={lam} cl_eps={eps} ===", flush=True)
            rows = trajectories[(lam, eps)] = []
            t0 = time.time()
            while state.epoch < args.epochs:
                state, loss = trainer.train_epoch(state)
                if state.epoch % args.eval_every == 0 or state.epoch == args.epochs:
                    m = trainer.evaluate(state)
                    print(
                        f"  e{state.epoch} loss={loss:.4f} "
                        + " ".join(f"{k}={v:.5f}" for k, v in sorted(m.items())),
                        flush=True,
                    )
                    rows.append({"epoch": state.epoch, "loss": float(loss),
                                 "elapsed_s": time.time() - t0, **m})
            print(f"  ({time.time()-t0:.0f}s)", flush=True)
    return trajectories


if __name__ == "__main__":
    main()
