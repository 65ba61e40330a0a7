"""The multi-rank dry run (the torch counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``): one full sharded train step and
one sharded eval top-k at tiny shapes, on an ``n_ranks`` mesh factored
as the JAX package factors its devices.

    python -m gsrs_tpu_torch.parallel.dryrun 4 [--device cpu] [--dist_backend gloo]
"""

from __future__ import annotations

import argparse
from typing import Optional, Tuple

import torch

from gsrs_tpu_torch.parallel.launch import build_kernels_for, spawn


def mesh_factors(n_ranks: int) -> Tuple[int, int]:
    """(data, model): the model axis is the largest of 2, 4, 8 that divides
    ``n_ranks`` and is at most half of it (so both axes exceed 1 when
    they can), as the JAX dry run factors its devices."""
    model_axis = 1
    for cand in (2, 4, 8):
        if n_ranks % cand == 0 and cand <= max(1, n_ranks // 2):
            model_axis = cand
    return n_ranks // model_axis, model_axis


def _rank(device: torch.device, data_axis: int, model_axis: int) -> dict:
    from gsrs_tpu_torch.config import ModelConfig, TrainConfig
    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.data.synthetic import clustered
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.ops.bitset import bitset_to_tensor, build_bitset
    from gsrs_tpu_torch.ops.ell import ell_from_interactions
    from gsrs_tpu_torch.ops.sampling import make_sampler_state, sample_triplets
    from gsrs_tpu_torch.parallel.dist_train import make_eval_scores_fn, make_train_step
    from gsrs_tpu_torch.parallel.mesh import make_mesh
    from gsrs_tpu_torch.parallel.sharding import GraphShardings
    from gsrs_tpu_torch.train.optim import make_optimizer

    n = data_axis * model_axis
    mesh = make_mesh(data_axis=data_axis, model_axis=model_axis, device=device)
    data = clustered(8 * n, 16 * n, n_clusters=4, seed=0)
    graph = build_graph(data, edge_pad_multiple=256)
    model = build_model(ModelConfig(num_layers=2, embedding_dim=8), graph,
                        ell=ell_from_interactions(data), device=device)
    sh = GraphShardings(mesh)
    sh.place_model(model)
    sh.init_params(model, torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    optimizer, _ = make_optimizer(TrainConfig(lr=1e-3), steps_per_epoch=1)
    opt_state = optimizer.init(params)
    step = make_train_step(model, optimizer, mesh, decay=1e-4)(params, opt_state)
    B = 8 * n
    state = make_sampler_state(data, device)
    users, pos, neg = sample_triplets(torch.Generator(device).manual_seed(0), state, B)
    params, opt_state, loss = step(params, opt_state, users, pos, neg)
    loss = float(loss)
    if not torch.isfinite(torch.tensor(loss)):
        raise RuntimeError(f"the sharded step's loss is {loss}")
    with torch.no_grad():
        all_users, items, _ = sh.call(model, "final_embeddings")
    train_rows = bitset_to_tensor(build_bitset(data.train_users, data.train_items,
                                               data.n_users, data.m_items), device)
    eval_users = torch.arange(B, device=device) % data.n_users
    scores, top = make_eval_scores_fn(model, mesh)(all_users, items, eval_users,
                                                   train_rows[eval_users], 8)
    if top.shape != (B // data_axis, 8) or not bool((top < data.m_items).all()):
        raise RuntimeError(f"the sharded eval top-k gave {tuple(top.shape)} ids")
    return {"loss": loss, "top": top.cpu()}


def dryrun_multichip(n_ranks: int, backend: Optional[str] = None,
                     device: str = "cuda") -> list:
    """One sharded step and one sharded eval on ``n_ranks`` ranks (on the
    cards, or on the CPU when ``device="cpu"``) → each rank's
    {"loss", "top"}; raises when a rank fails."""
    data_axis, model_axis = mesh_factors(n_ranks)
    print(f"[dryrun] mesh: data={data_axis} × model={model_axis}")
    build_kernels_for(device)
    out = spawn(_rank, n_ranks, data_axis, model_axis, device_type=device, backend=backend)
    print(f"[dryrun] train step OK, loss={out[0]['loss']:.4f}; sharded eval top-k OK")
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="gsrs_tpu_torch.parallel.dryrun")
    p.add_argument("n_ranks", type=int)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None)
    args = p.parse_args(argv)
    dryrun_multichip(args.n_ranks, args.dist_backend, args.device)


if __name__ == "__main__":
    main()
