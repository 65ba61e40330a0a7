"""Sequential-family epoch time on the card (port of
``tools/bench_seq_tpu.py``, renamed for the device it times).

    python -m gsrs_tpu_torch.tools.bench_seq [--epochs 3] [--device cuda:0]

SASRec, GRU4Rec and BERT4Rec at 100k users × 20k items × sequences of
64, batch 1024, d 128 (2 blocks or layers, 2 heads), bf16, dropout 0.2,
on cluster-Markov sequences (`data.sequences.synthetic_markov_sequences`,
50 clusters, seed 3): a warm-up epoch, then ``--epochs`` epochs on the
host clock; a warm eval (K1 scores each of its batches of 2048), then
one timed. Each row prints the JAX tool's keys (epoch s, seqs/s, eval s,
recall@10) and the kernels' launches over the model's epochs and evals.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

KINDS = ("sasrec", "gru4rec", "bert4rec")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="gsrs_tpu_torch.tools.bench_seq")
    ap.add_argument("--n_users", type=int, default=100_000)
    ap.add_argument("--m_items", type=int, default=20_000)
    ap.add_argument("--max_len", type=int, default=64)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--device", default=None, help="torch device (default cuda:0)")
    return ap


def bench_model(kind: str, data, args, device):
    """One model's epochs and evals → (its row, its trainer, its state)."""
    from gsrs_tpu_torch.kernels import launch_counts, launches_since
    from gsrs_tpu_torch.models.registry import build_seq_model
    from gsrs_tpu_torch.train.seq_trainer import SeqTrainer

    model = build_seq_model(kind, m_items=args.m_items, max_len=args.max_len, dim=args.dim,
                            hidden=args.dim, blocks=2, heads=2, dropout=0.2, bf16=True,
                            device=device)
    tr = SeqTrainer(model, data, batch_size=args.batch, lr=1e-3, seed=0, topks=(10,),
                    eval_batch=2048, device=device)
    before = launch_counts()
    state = tr.init_state()
    state, _ = tr.train_epoch(state)  # warm-up
    t0 = time.time()
    for _ in range(args.epochs):
        state, loss = tr.train_epoch(state)  # reads the loss: ends synchronized
    epoch_s = (time.time() - t0) / args.epochs
    tr.evaluate(state)  # warm
    t0 = time.time()
    m = tr.evaluate(state)  # reads its sums: ends synchronized
    row = {
        "model": kind,
        "epoch_s": round(epoch_s, 3),
        "seqs_per_s": round(args.n_users / epoch_s),
        "eval_s": round(time.time() - t0, 3),
        "recall@10": round(m.get("recall@10", 0.0), 5),
        "launches": launches_since(before),
    }
    return row, tr, state


def main(argv: Optional[list] = None) -> dict:
    """→ {model: (its row, its trainer, its final state)}."""
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)

    from gsrs_tpu_torch.data.sequences import synthetic_markov_sequences
    from gsrs_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    data = synthetic_markov_sequences(n_users=args.n_users, m_items=args.m_items, n_clusters=50,
                                      max_len=args.max_len, seed=3)
    out = {}
    for kind in KINDS:
        out[kind] = bench_model(kind, data, args, device)
        print(json.dumps(out[kind][0]), flush=True)
    return out


if __name__ == "__main__":
    main()
