"""End-to-end learnability drive (port of ``tools/drive_tpu.py``).

A 200 × 300 dataset in 5 clusters, where in-cluster interactions are 50×
likelier and every even user holds out one unseen in-cluster item, is
trained for 150 BPR steps of 1024 triplets sampled on the device
(LightGCN, 2 layers, dim 16, Adam at lr 5e-2, decay 1e-4), then every
test user's top-20 is taken with the train positives masked. On such
data a trained model lands far above chance (20/300 ≈ 0.067).

    python -m gsrs_tpu_torch.drive [--device cpu]
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from gsrs_tpu_torch.config import EvalConfig, ExperimentConfig, ModelConfig, TrainConfig
from gsrs_tpu_torch.data.adjacency import build_graph
from gsrs_tpu_torch.data.dataset import InteractionData
from gsrs_tpu_torch.device import DeviceLike, resolve_device
from gsrs_tpu_torch.models.registry import build_model
from gsrs_tpu_torch.ops.ell import ell_from_interactions
from gsrs_tpu_torch.ops.sampling import sample_epoch, sample_triplets
from gsrs_tpu_torch.ops.topk import masked_topk
from gsrs_tpu_torch.train.trainer import Trainer


def drive_data(seed: int = 7) -> InteractionData:
    """The drive's dataset, the same arrays as ``tools/drive_tpu.py``."""
    rng = np.random.default_rng(seed)
    n, m, C = 200, 300, 5
    uc, ic = rng.integers(0, C, n), rng.integers(0, C, m)
    prob = np.where(uc[:, None] == ic[None, :], 0.25, 0.005)
    mask = rng.random((n, m)) < prob
    mask[np.arange(n), rng.integers(0, m, n)] = True
    test_dict = {}
    for usr in range(0, n, 2):
        cand = np.flatnonzero((~mask[usr]) & (ic == uc[usr]))
        if cand.size:
            test_dict[usr] = np.array([int(rng.choice(cand))])
    u, i = np.nonzero(mask)
    return InteractionData("drive", n, m, u.astype(np.int64), i.astype(np.int64), test_dict)


def drive(
    device: DeviceLike = None, steps: int = 150, fused_adam: str = "pallas", seed: int = 0
) -> Dict[str, float]:
    """Trains and evaluates on ``device`` (default ``cuda:0``) → the first
    and last step loss, recall@20 of the test users, the share of
    sampled triplets that break the sampler's contract and the number of
    train positives in the top-20 lists (both 0 when all is well)."""
    device = resolve_device(device)
    data = drive_data()
    cfg = ExperimentConfig(
        model=ModelConfig(num_layers=2, embedding_dim=16),
        train=TrainConfig(batch_size=1024, lr=5e-2, decay=1e-4, seed=seed,
                          fused_adam=fused_adam),
        eval=EvalConfig(test_batch=128, topks=(20,)),
    )
    graph = build_graph(data, edge_pad_multiple=1024)
    model = build_model(cfg.model, graph, ell=ell_from_interactions(data), device=device)
    trainer = Trainer(cfg, data, graph, model, device=device)
    state = trainer.init_state()
    g = torch.Generator(device).manual_seed(seed)
    batches = sample_epoch(g, trainer.sampler_state, steps * 1024, 1024)
    state, losses = trainer.run_steps(state, *batches)
    losses = losses.cpu().numpy()

    dense = np.zeros((data.n_users, data.m_items), bool)
    dense[data.train_users, data.train_items] = True
    users, pos, neg = (t.cpu().numpy() for t in sample_triplets(g, trainer.sampler_state, 4096))
    bad_triplets = float(np.mean(~dense[users, pos] | dense[users, neg]))

    test_users = torch.as_tensor(data.test_users(), device=device)
    with torch.no_grad():
        all_users, items, _ = model.final_embeddings()
    seen = trainer.sampler_state.train_bitset
    _, top = masked_topk(all_users[test_users], items, seen[test_users], 20)
    leaked = int(dense[np.repeat(data.test_users(), 20), top.cpu().numpy().ravel()].sum())
    metrics = trainer.evaluate(state)
    return dict(loss_first=float(losses[0]), loss_last=float(losses[-1]),
                recall20=metrics["recall@20"], bad_triplets=bad_triplets,
                leaked_positives=leaked)


def main(argv: Optional[list] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(prog="gsrs_tpu_torch.drive")
    ap.add_argument("--device", default=None, help="torch device (default cuda:0)")
    args = ap.parse_args(argv)
    out = drive(args.device)
    print(f"loss: {out['loss_first']:.4f} -> {out['loss_last']:.4f}; recall@20 "
          f"{out['recall20']:.4f} (chance ≈ 0.067); bad triplets {out['bad_triplets']}; "
          f"train positives in top-20: {out['leaked_positives']}")
    ok = (out["loss_last"] < 0.1 and out["recall20"] > 0.3 and out["bad_triplets"] == 0
          and out["leaked_positives"] == 0)
    print("DRIVE OK" if ok else "DRIVE FAILED")
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
