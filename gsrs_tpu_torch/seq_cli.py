"""Command-line training of the sequential family (port of
`gsrs_tpu.seq_cli`): SASRec, GRU4Rec and BERT4Rec, and the port's own
HSTU.

    python -m gsrs_tpu_torch.seq_cli --dataset gowalla --model sasrec --epochs 50
    python -m gsrs_tpu_torch.seq_cli --synthetic --model gru4rec

The JAX CLI's flags, names and defaults. Sequences come from each user's
interactions in file order (leave-last-item-out); metrics are HR@k
(recall with one ground-truth item) and NDCG@k over the full catalog with
the history masked. Runs on ``cuda:0`` and raises when there is no card;
`main`'s ``device`` keyword lets a caller (the tests) ask for the CPU. A
``--data_axis D --model_axis M`` mesh starts its D · M ranks here, as
`gsrs_tpu_torch.cli` does (``--dist_backend gloo`` for several ranks on
one card): batches over the data axis, the item table row-sharded over
the model axis.

BERT4Rec as published (Sun et al., CIKM 2019; ML-20M's run script):
``--model bert4rec --published 40 --max_len 200 --dim 64 --hidden 256
--heads 2 --batch 256 --lr 1e-4``. ``--published P`` builds the
published model with P prediction slots a sequence, at the published
cloze ratio and last-item-only share (`PUBLISHED_CLOZE`), and trains it
with BERT's optimizer (`PUBLISHED_OPTIM`).

HSTU (Zhai et al., ICML 2024; the released ML-20M large settings):
``--model hstu --max_len 200 --dim 256 --blocks 8 --heads 4 --hidden 64
--batch 128 --lr 1e-3`` on a dataset with times (the MovieLens
converter's ``train_times.txt``; without them it stops); ``--hidden`` is
a head's width, the sampled softmax takes the released 128 negatives a
slot at temperature 0.05, and the optimizer is the released AdamW
(`HSTU_OPTIM`).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

from gsrs_tpu_torch.cli import add_backend_flag, launch_if_needed
from gsrs_tpu_torch.device import DeviceLike

# BERT4Rec's published cloze: ρ = 0.2, and one last-item-only sample a user
# beside the released data's ten cloze copies
PUBLISHED_CLOZE = dict(mask_prob=0.2, last_only_prob=1 / 11)
# BERT's optimizer (the released code's optimization.py and run_ml-20m.sh)
PUBLISHED_OPTIM = dict(warmup_steps=100, decay_steps=400_000, weight_decay=0.01,
                       clip_norm=5.0, adam_eps=1e-6)
# HSTU's released AdamW: betas (0.9, 0.98), no weight decay, warm-up or clip
HSTU_OPTIM = dict(adam_betas=(0.9, 0.98))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gsrs_tpu_torch.seq_cli")
    p.add_argument("--model", choices=["sasrec", "gru4rec", "bert4rec", "hstu"],
                   default="sasrec")
    p.add_argument("--dataset", type=str, default="gowalla")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--synthetic", action="store_true", help="markov synthetic data")
    p.add_argument("--max_len", type=int, default=50)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--blocks", type=int, default=2, help="attention blocks / GRU layers")
    p.add_argument("--heads", type=int, default=1)
    p.add_argument("--dropout", type=float, default=0.2)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--decay", type=float, default=0.0)
    p.add_argument("--published", type=int, default=0,
                   help="BERT4Rec as published with this many prediction slots a sequence "
                        "(40 in ML-20M's run script), trained with BERT's optimizer")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--eval_every", type=int, default=10)
    p.add_argument("--topks", type=str, default="[10,20]")
    p.add_argument("--seed", type=int, default=2020)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--data_axis", type=int, default=1)
    p.add_argument("--model_axis", type=int, default=1)
    add_backend_flag(p)
    p.add_argument("--tensorboard", type=int, default=0)
    p.add_argument("--comment", type=str, default="")
    return p


def main(argv: Optional[list] = None, device: DeviceLike = None):
    """Train as the flags say → (the `SeqTrainer`, the final
    `SeqTrainState`); the trainer's model holds the final parameters.
    ``device`` defaults to ``cuda:0``. A mesh started here returns None
    once every rank has finished; in a rank, ``device`` is the rank's."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if launch_if_needed(_rank_entry, argv, args.data_axis * args.model_axis,
                        args.dist_backend, device):
        return None

    from gsrs_tpu_torch.config import topks_from_string
    from gsrs_tpu_torch.data.sequences import (
        sequences_from_interactions, synthetic_markov_sequences,
    )
    from gsrs_tpu_torch.device import resolve_device
    from gsrs_tpu_torch.models.registry import build_seq_model
    from gsrs_tpu_torch.train.seq_trainer import SeqTrainer

    device = resolve_device(device)
    if args.model == "hstu" and args.synthetic:
        raise SystemExit("HSTU trains on each item's time: the synthetic sequences have none "
                         "(give a dataset directory with train_times.txt)")
    if args.synthetic:
        seq_data = synthetic_markov_sequences(max_len=args.max_len, seed=args.seed)
    else:
        from gsrs_tpu_torch.data.dataset import load_dataset, load_lastfm

        data_root = args.data_root or os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
        ddir = os.path.join(data_root, args.dataset)
        if args.dataset == "lastfm":  # the reference-shipped format, no train.txt
            data = load_lastfm(ddir)
        else:
            data = load_dataset(ddir, name=args.dataset)
        if args.model == "hstu" and data.train_times is None:
            raise SystemExit(f"HSTU trains on each item's time: {ddir} has no train_times.txt "
                             f"(the MovieLens converter writes it)")
        seq_data = sequences_from_interactions(data, max_len=args.max_len)
    print(f"[seq] {seq_data.name}: {len(seq_data.train_seqs)} sequences, "
          f"{seq_data.m_items} items, max_len {seq_data.max_len}")

    published = dict(PUBLISHED_CLOZE, published=args.published) if args.published else {}
    model = build_seq_model(args.model, m_items=seq_data.m_items, max_len=args.max_len,
                            dim=args.dim, hidden=args.hidden, blocks=args.blocks,
                            heads=args.heads, dropout=args.dropout, bf16=args.bf16,
                            device=device, **published)
    optim = PUBLISHED_OPTIM if args.published else {}
    if args.model == "hstu":
        optim = HSTU_OPTIM
    mesh = None
    if args.data_axis * args.model_axis > 1:
        from gsrs_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(data_axis=args.data_axis, model_axis=args.model_axis, device=device)
        print(f"[seq] mesh: data={args.data_axis} × model={args.model_axis} ({mesh.backend})")
    trainer = SeqTrainer(model, seq_data, batch_size=args.batch, lr=args.lr, decay=args.decay,
                         seed=args.seed, topks=topks_from_string(args.topks), mesh=mesh,
                         device=device, **optim)
    state = trainer.fit(epochs=args.epochs, checkpoint_dir=args.checkpoint_dir,
                        eval_every=args.eval_every, resume=args.resume,
                        tensorboard=bool(args.tensorboard), comment=args.comment)
    return trainer, state


def _rank_entry(device, argv) -> None:
    main(argv, device=device)


if __name__ == "__main__":
    main()
