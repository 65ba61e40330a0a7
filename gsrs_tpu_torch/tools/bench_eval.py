"""Eval throughput of the full-catalog masked top-k engine across its
options (port of ``tools/bench_eval.py``).

    python -m gsrs_tpu_torch.tools.bench_eval [--checkpoint_dir CK] [--dataset_dir DS] \\
        [--skip_scale] [--recall_target 0.98] [--test_batch 2048] [--device cuda:0]

Five variants, each a full `Evaluator.run` timed warm (3 runs after one):

  auto, exact             K1 (natural layout) + exact top-k
  approx                  K1 + the approximate top-k at --recall_target
  pallas-bitplane+exact   K2 (the bit-plane layout) + exact top-k
  pallas-natural+exact    K1 + exact top-k

(on the card the natural layout needs no permutation, so ``auto`` is the
natural layout at every catalog size: `ops.scoring.resolve_bitplane_scoring`).
Each row carries the K1 and K2 launches of its runs, so it shows which
kernel scored. Datasets: ``--dataset_dir`` (default ``data/gowalla``;
where it holds no train.txt, the Gowalla-shaped stand-in of
`gsrs_tpu_torch.bench`), with a checkpoint's parameters or seeded random
ones, and the amazon-book-scale stand-in (52,643 users × 91,599 items,
`stress_pod.big_synthetic(..., avg_degree=57, seed=0)`, 10 random
held-out items a user from ``default_rng(1)``) with random parameters.
The model is the JAX tool's: LightGCN, 3 layers, dim 64, bf16.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Mapping, Optional

def variants(recall_target: float = 0.98):
    """[(label, EvalConfig keywords)] as the JAX tool lists them."""
    return [
        ("auto", dict(topk_method="exact")),
        ("exact", dict(topk_method="exact", use_pallas_scoring="off")),
        ("approx", dict(topk_method="approx", use_pallas_scoring="off",
                        topk_recall_target=recall_target)),
        ("pallas-bitplane+exact", dict(topk_method="exact", use_pallas_scoring=True)),
        ("pallas-natural+exact", dict(topk_method="exact", use_pallas_scoring=True,
                                      pallas_variant="natural")),
    ]


def time_eval(ev, reps=3):
    """→ (seconds a warm `Evaluator.run`, its metrics); the model holds
    the parameters that the JAX tool passes."""
    from gsrs_tpu_torch.device import synchronize

    ev.run()  # warm
    synchronize(ev.device)
    t0 = time.time()
    for _ in range(reps):
        m = ev.run()  # reads its sums: ends synchronized
    dt = (time.time() - t0) / reps
    return dt, m


def bench_dataset(name, data, model, params: Optional[Mapping], topk_variants, test_batch=2048):
    """Each variant on ``data`` → its rows. ``params``: a state dict loaded
    into ``model`` first, or None for the model's own parameters."""
    from gsrs_tpu_torch.config import EvalConfig
    from gsrs_tpu_torch.kernels import launch_counts, launches_since
    from gsrs_tpu_torch.train.evaluator import Evaluator

    if params is not None:
        model.load_state_dict(params)
    out = []
    for label, cfg_kw in topk_variants:
        cfg = EvalConfig(test_batch=test_batch, topks=(20,), **cfg_kw)
        ev = Evaluator(data, model, cfg, device=model.user_emb.device)
        before = launch_counts()
        dt, metrics = time_eval(ev)
        launches = launches_since(before)
        row = {
            "dataset": name,
            "variant": label,
            "eval_sec": round(dt, 4),
            "eval_users_per_s_per_chip": round(ev.n_test_users / dt),
            "recall@20": round(metrics.get("recall@20", 0.0), 5),
            "ndcg@20": round(metrics.get("ndcg@20", 0.0), 5),
            "launches": {k: launches[k] for k in ("masked_scores", "masked_scores_bitplane")},
        }
        out.append(row)
        print(json.dumps(row), flush=True)
    return out


def amazon_scale_standin():
    """The amazon-book-scale stand-in with its held-out split
    (`bench_scale_standin.held_out_standin`)."""
    from gsrs_tpu_torch.tools.bench_scale_standin import SHAPES, held_out_standin

    return held_out_standin(**SHAPES["amazon-book-scale"])


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="gsrs_tpu_torch.tools.bench_eval")
    ap.add_argument("--checkpoint_dir", default=None,
                    help="a trained checkpoint, for meaningful quality deltas")
    ap.add_argument("--skip_scale", action="store_true")
    ap.add_argument("--recall_target", type=float, default=0.98)
    ap.add_argument("--test_batch", type=int, default=2048)
    ap.add_argument("--dataset_dir", default="data/gowalla",
                    help="the first dataset; the Gowalla-shaped stand-in where it has no train.txt")
    ap.add_argument("--device", default=None, help="torch device (default cuda:0)")
    return ap


def main(argv: Optional[list] = None) -> list:
    """→ the rows printed."""
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)

    import torch

    from gsrs_tpu_torch.bench import gowalla_or_stand_in
    from gsrs_tpu_torch.config import ModelConfig
    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.device import resolve_device
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.ops.ell import ell_from_interactions

    device = resolve_device(args.device)
    topk_variants = variants(args.recall_target)
    results = []

    data, label, _ = gowalla_or_stand_in(args.dataset_dir)
    name = "gowalla" if label == "gowalla" else "gowalla-standin"
    print(f"[data] {label}")
    graph = build_graph(data)
    cfg = ModelConfig(num_layers=3, embedding_dim=64, bf16_compute=True)
    model = build_model(cfg, graph, ell=ell_from_interactions(data), device=device)
    if args.checkpoint_dir:
        # the weights of the checkpoint the Trainer would resume from
        from gsrs_tpu_torch.config import ExperimentConfig, TrainConfig
        from gsrs_tpu_torch.train.trainer import Trainer

        tcfg = ExperimentConfig(model=cfg, train=TrainConfig(
            checkpoint_dir=args.checkpoint_dir, resume=True, tensorboard=False))
        tr = Trainer(tcfg, data, graph, model, run_eval=False, device=device)
        state = tr.resume_weights(tr.init_state())
        if state.epoch == 0:
            # resume_weights returns the fresh state when no checkpoint resolves
            raise SystemExit(
                f"[params] NO checkpoint resolved under {args.checkpoint_dir} (state.epoch == 0): "
                "refusing to report random-params quality as restored; run without "
                "--checkpoint_dir for timing-only numbers")
        print(f"[params] restored {args.checkpoint_dir} @ epoch {state.epoch}")
    else:
        model.init_params(torch.Generator().manual_seed(0))
        print("[params] RANDOM (quality deltas vacuous; timing valid)")
    results += bench_dataset(name, data, model, None, topk_variants, args.test_batch)
    del model

    if not args.skip_scale:
        sdata = amazon_scale_standin()
        sgraph = build_graph(sdata)
        smodel = build_model(cfg, sgraph, ell=ell_from_interactions(sdata), device=device,
                             generator=torch.Generator().manual_seed(0))
        results += bench_dataset("amazon-book-scale", sdata, smodel, None, topk_variants,
                                 args.test_batch)

    print("== summary ==")
    for r in results:
        print(json.dumps(r))
    return results


if __name__ == "__main__":
    main()
