"""The sequential family's planted-order benchmark (port of
``tools/bench_seq_markov.py``).

    python -m gsrs_tpu_torch.tools.bench_seq_markov [--epochs 60] [--n_users 4000] \\
        [--m_items 1000] [--clusters 20] [--max_len 30] [--dim 64] [--device cuda:0]

The order signal is planted: cluster-Markov walks
(`data.sequences.synthetic_markov_sequences`, seed 11) whose next item is
predictable only from the recent items' cluster. A model that uses the
order beats chance and the order-blind popularity ranker
(`popularity_baseline`, the JAX tool's); one that does not, cannot. The
chance and popularity rows print first; then SASRec, GRU4Rec and BERT4Rec
(2 blocks, 2 heads, dropout 0.2, batch 256, lr 1e-3, seed 0) each train
``--epochs`` epochs and are evaluated (recall and NDCG at 10 and 20; the
masked-scoring kernel, K1, scores every eval batch of 512). Each model's
row carries the JAX tool's keys, ``vs_popularity_recall@10`` among them,
and the kernels' launches over its epochs and eval.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

KINDS = ("sasrec", "gru4rec", "bert4rec")


def popularity_baseline(data, topks):
    """Order-blind ranker: global item frequency, per-user masking of
    history (same protocol as SeqTrainer.evaluate)."""
    import numpy as np

    counts = np.bincount(
        data.train_seqs.reshape(-1), minlength=data.m_items + 1
    )[1:]  # ids are 1-based in seqs; 0 is padding
    out = {}
    for k in topks:
        hits = ndcg = 0.0
        for u, tgt in zip(data.eval_users, data.eval_targets):
            c = counts.copy()
            hist = data.train_seqs[u]
            c[hist[hist > 0] - 1] = -1  # mask history
            top = np.argpartition(-c, k)[:k]
            top = top[np.argsort(-c[top])]
            rank = np.where(top == (tgt - 1))[0]
            if rank.size:
                hits += 1.0
                ndcg += 1.0 / np.log2(rank[0] + 2)
        n = len(data.eval_users)
        out[f"recall@{k}"] = hits / n
        out[f"ndcg@{k}"] = ndcg / n
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="gsrs_tpu_torch.tools.bench_seq_markov")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--n_users", type=int, default=4000)
    ap.add_argument("--m_items", type=int, default=1000)
    ap.add_argument("--clusters", type=int, default=20)
    ap.add_argument("--max_len", type=int, default=30)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--device", default=None, help="torch device (default cuda:0)")
    return ap


def main(argv: Optional[list] = None) -> list:
    """→ the rows printed: chance, popularity, then each model's."""
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)

    from gsrs_tpu_torch.data.sequences import synthetic_markov_sequences
    from gsrs_tpu_torch.device import resolve_device
    from gsrs_tpu_torch.kernels import launch_counts, launches_since
    from gsrs_tpu_torch.models.registry import build_seq_model
    from gsrs_tpu_torch.train.seq_trainer import SeqTrainer

    device = resolve_device(args.device)
    data = synthetic_markov_sequences(
        n_users=args.n_users, m_items=args.m_items,
        n_clusters=args.clusters, max_len=args.max_len, seed=11,
    )
    topks = (10, 20)
    chance = {f"recall@{k}": k / args.m_items for k in topks}
    rows = [{"model": "chance", **{k: round(v, 5) for k, v in chance.items()}}]
    print(json.dumps(rows[-1]))
    pop = popularity_baseline(data, topks)
    rows.append({"model": "popularity", **{k: round(v, 5) for k, v in pop.items()}})
    print(json.dumps(rows[-1]))

    for kind in KINDS:
        model = build_seq_model(
            kind, m_items=args.m_items, max_len=args.max_len,
            dim=args.dim, hidden=args.dim, blocks=2, heads=2, dropout=0.2, device=device,
        )
        tr = SeqTrainer(model, data, batch_size=256, lr=1e-3, seed=0,
                        topks=topks, eval_batch=512, device=device)
        before = launch_counts()
        state = tr.init_state()
        t0 = time.time()
        for _ in range(args.epochs):
            state, loss = tr.train_epoch(state)  # reads the loss: ends synchronized
        dt = time.time() - t0
        m = tr.evaluate(state)
        rows.append({
            "model": kind,
            **{k: round(v, 5) for k, v in m.items()},
            "train_s": round(dt, 1),
            "epochs": args.epochs,
            "vs_popularity_recall@10": round(
                m["recall@10"] / max(pop["recall@10"], 1e-9), 2
            ),
            "launches": launches_since(before),
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
