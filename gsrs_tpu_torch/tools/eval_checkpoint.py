"""One-off full-catalog evaluation of a saved checkpoint (port of
``tools/eval_checkpoint.py``).

    python -m gsrs_tpu_torch.tools.eval_checkpoint --checkpoint_dir CK \\
        --dataset gowalla [--data_root ROOT] [--topks "[20]"] [--device cpu]

Both families: when ``CK/model_meta.json`` names a sequential model
(sasrec, gru4rec, bert4rec), the dataset becomes leave-last-out
sequences and `SeqTrainer.evaluate` scores them (dropout 0); otherwise
the graph model that the meta describes (the flags for a run that left
none) is built with its training layout and its i2i graph, restored
through `Trainer.resume_weights` (the checkpoint that `maybe_resume`
finds, without its optimizer state, so a run trained with either
``--fused_adam`` setting loads) and scored by `Trainer.evaluate`. K1
scores every eval batch; the graph propagation runs K4. With the run's
eval batch and top-k list it reproduces the run's last eval.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="gsrs_tpu_torch.tools.eval_checkpoint")
    ap.add_argument("--checkpoint_dir", required=True)
    ap.add_argument("--dataset", default="gowalla")
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--model", default="lgn")
    ap.add_argument("--layer", type=int, default=3)
    ap.add_argument("--recdim", type=int, default=64)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--topks", default="[20]")
    ap.add_argument("--testbatch", type=int, default=2048)
    ap.add_argument("--device", default=None, help="torch device (default cuda:0)")
    return ap


def _print_metrics(epoch: int, metrics: Dict[str, float]) -> None:
    print(f"[eval e{epoch}] " + " ".join(f"{k}={v:.5f}" for k, v in sorted(metrics.items())))


def main(argv: Optional[list] = None) -> Dict[str, float]:
    """Evaluate the checkpoint as the flags say → its metrics."""
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)

    from gsrs_tpu_torch.cli import layout_from_interactions
    from gsrs_tpu_torch.config import (
        EvalConfig, ExperimentConfig, ModelConfig, TrainConfig, _repo_root, topks_from_string,
    )
    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.data.dataset import load_dataset, load_lastfm
    from gsrs_tpu_torch.device import resolve_device
    from gsrs_tpu_torch.models.registry import SEQ_MODELS, build_model
    from gsrs_tpu_torch.serve import model_config_from_meta
    from gsrs_tpu_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    ddir = os.path.join(args.data_root or os.path.join(_repo_root(), "data"), args.dataset)
    if args.dataset == "lastfm":
        data = load_lastfm(ddir)
    else:
        data = load_dataset(ddir, name=args.dataset)

    meta = None
    meta_path = os.path.join(args.checkpoint_dir, "model_meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        print(f"[eval] using {meta_path}")
    if meta is not None and meta.get("kind") in SEQ_MODELS:
        return _eval_sequential(args, data, meta, device)

    graph = build_graph(data, cache_dir=ddir)
    if meta is not None:
        model_cfg = model_config_from_meta(meta)
    else:
        model_cfg = ModelConfig(model=args.model, num_layers=args.layer,
                                embedding_dim=args.recdim, bf16_compute=args.bf16)
    cfg = ExperimentConfig(
        model=model_cfg,
        train=TrainConfig(checkpoint_dir=args.checkpoint_dir, resume=True, tensorboard=False),
        eval=EvalConfig(test_batch=args.testbatch, topks=topks_from_string(args.topks)),
    )
    i2i = None
    if cfg.model.use_item_item and cfg.model.i2i_path:
        # an i2i-trained checkpoint evaluated without its i2i graph would
        # score other embeddings than training produced
        import scipy.sparse as sp

        from gsrs_tpu_torch.models.lightgcn import ItemItemGraph

        i2i = ItemItemGraph.from_scipy(sp.load_npz(cfg.model.i2i_path))
    model = build_model(cfg.model, graph, i2i, layout_from_interactions(cfg.model, data),
                        device=device, cache_dir=ddir)
    trainer = Trainer(cfg, data, graph, model, device=device)
    if trainer.ckpt.resolve_resume_path(None) is None:
        raise SystemExit(f"no checkpoint under {args.checkpoint_dir}")
    state = trainer.resume_weights(trainer.init_state())
    print(f"[eval] checkpoint epoch {state.epoch}")
    metrics = trainer.evaluate(state)
    _print_metrics(state.epoch, metrics)
    return metrics


def _eval_sequential(args, data, meta: dict, device) -> Dict[str, float]:
    from gsrs_tpu_torch.config import topks_from_string
    from gsrs_tpu_torch.data.sequences import sequences_from_interactions
    from gsrs_tpu_torch.models.registry import build_seq_model
    from gsrs_tpu_torch.train.checkpoint import CheckpointManager
    from gsrs_tpu_torch.train.seq_trainer import SeqTrainer

    seq_data = sequences_from_interactions(data, max_len=meta["max_len"])
    model = build_seq_model(meta["kind"], m_items=seq_data.m_items, max_len=meta["max_len"],
                            dim=meta["dim"], hidden=meta["hidden"], blocks=meta["blocks"],
                            heads=meta["heads"], dropout=0.0, device=device)
    trainer = SeqTrainer(model, seq_data, eval_batch=args.testbatch,
                         topks=topks_from_string(args.topks), device=device)
    state = trainer.init_state()
    ckpt = CheckpointManager(args.checkpoint_dir)
    path = ckpt.resolve_resume_path(None)
    if path is None:
        raise SystemExit(f"no checkpoint under {args.checkpoint_dir}")
    state = trainer.restore(state, ckpt.restore(path))
    print(f"[eval] checkpoint epoch {state.epoch} ({meta['kind']})")
    metrics = trainer.evaluate(state)
    _print_metrics(state.epoch, metrics)
    return metrics


if __name__ == "__main__":
    main()
