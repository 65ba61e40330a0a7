"""A profiler trace and phase timings over a few training epochs (port of
``tools/profile_epoch.py``).

    python -m gsrs_tpu_torch.tools.profile_epoch --dataset gowalla --epochs 2 \\
        --trace_dir TRACE [--bf16] [--bpr_batch 8192] [--eval] [--device cuda:0]

LightGCN on ``<data_root>/<dataset>`` (default ``data/`` in the
repository): a warm-up epoch (and, under ``--eval``, a warm-up eval),
then ``--epochs`` epochs (each followed by a full-catalog eval under
``--eval``) inside `utils.timer.profile_trace`, which writes a
`torch.profiler` Chrome trace of the host's and the card's activity under
``--trace_dir`` (TensorBoard's profiler format); the card's rows name the
kernels (``ell_gather_reduce`` for K4, ``masked_scores`` for K1). Then
`Timer.summary()` of this run (the tape is zeroed first), with the JAX
tool's phase names: ``load_data``,
``init``, ``warmup_epoch_incl_compile``, ``warmup_eval_incl_compile``,
``epoch`` and ``eval``; with ``--trace_dir``, also the spans' own time a
step and an eval, from the profiled epochs' span tape
(`utils.timer.spans`). Nothing is compiled here as XLA compiles: the
"compile" of the warm-up phases is the first use's work, the kernels'
build (`gsrs_tpu_torch.kernels`, cached under ``build/kernels``) and
loading included.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="gsrs_tpu_torch.tools.profile_epoch")
    ap.add_argument("--dataset", default="gowalla")
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--bpr_batch", type=int, default=2048)
    ap.add_argument("--layer", type=int, default=3)
    ap.add_argument("--recdim", type=int, default=64)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--trace_dir", default=None, help="torch.profiler output dir")
    ap.add_argument("--eval", action="store_true",
                    help="also profile full-catalog evals (propagation + scoring)")
    ap.add_argument("--device", default=None, help="torch device (default cuda:0)")
    return ap


def main(argv: Optional[list] = None) -> str:
    """→ the phase summary printed."""
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)

    from gsrs_tpu_torch.config import ExperimentConfig, ModelConfig, TrainConfig, _repo_root
    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.data.dataset import load_dataset
    from gsrs_tpu_torch.device import resolve_device
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.ops.ell import ell_from_interactions
    from gsrs_tpu_torch.train.trainer import Trainer
    from gsrs_tpu_torch.utils.timer import Timer, profile_trace, spans

    device = resolve_device(args.device)
    ddir = os.path.join(args.data_root or os.path.join(_repo_root(), "data"), args.dataset)
    Timer.zero()  # the tape is the process's: this run's phases only
    with Timer.named("load_data"):
        data = load_dataset(ddir, name=args.dataset)
        graph = build_graph(data, cache_dir=ddir)
        ell = ell_from_interactions(data)
    cfg = ExperimentConfig(
        model=ModelConfig(
            num_layers=args.layer,
            embedding_dim=args.recdim,
            bf16_compute=args.bf16,
        ),
        train=TrainConfig(batch_size=args.bpr_batch, tensorboard=False),
    )
    model = build_model(cfg.model, graph, ell=ell, device=device)
    trainer = Trainer(cfg, data, graph, model, run_eval=args.eval, device=device)
    with Timer.named("init"):
        state = trainer.init_state()
    with Timer.named("warmup_epoch_incl_compile"):
        state, _ = trainer.train_epoch(state)
    if trainer.evaluator is not None:
        with Timer.named("warmup_eval_incl_compile"):
            trainer.evaluator.run()
    with profile_trace(args.trace_dir):
        for _ in range(args.epochs):
            with Timer.named("epoch"):
                state, loss = trainer.train_epoch(state)
            if trainer.evaluator is not None:
                with Timer.named("eval"):
                    trainer.evaluator.run()
    summary = Timer.summary()
    print(summary)
    if args.trace_dir:
        print(span_summary(spans()))
        print(f"trace written to {args.trace_dir}")
    return summary


def span_summary(tape) -> str:
    """The profiled spans' own milliseconds a step (under ``train.call``)
    and an eval (under ``eval.run``), by span, the largest first."""
    from gsrs_tpu_torch.utils.timer import own_ns

    lines = []
    for label, call, unit in (("a step", "train.call", "train.step"),
                              ("an eval", "eval.run", "eval.run")):
        n = sum(s.name == unit for s in tape)
        if not n:
            continue
        parts = sorted(own_ns(tape, call).items(), key=lambda kv: -kv[1])
        lines.append(f"spans, own ms {label} ({n}): "
                     + " | ".join(f"{name} {ns / n / 1e6:.3f}" for name, ns in parts))
    return "\n".join(lines)


if __name__ == "__main__":
    main()
