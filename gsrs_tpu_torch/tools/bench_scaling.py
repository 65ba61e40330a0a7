"""Scaling efficiency of the sharded train step: examples/s at mesh sizes
1 → N (port of ``tools/bench_scaling.py``).

    python -m gsrs_tpu_torch.tools.bench_scaling --devices 1 2 4 [--batch 8192] \\
        [--steps 30] [--dist_backend nccl|gloo] [--device cuda|cpu]

LightGCN on a power-law graph (``--n_users`` × ``--m_items``, average
degree 27, seed 0) on the ELL layout in bf16, trained by
`parallel.dist_train.make_train_step` on a (data, model) mesh of each
size: the model axis is 2 at 4 or more ranks, else 1, and a size that it
does not divide is skipped, as in the JAX tool. Size 1 runs in this
process; a larger size starts its ranks through `parallel.launch.spawn`,
each building the data, the model (seeded parameters, the same on every
mesh) and one seeded batch, the same on every rank. Each size takes one
warm-up step, then ``--steps`` steps, reads the loss (which waits for the
device) and takes the host clock. Efficiency is against the first size
measured.

Under NCCL (the default on CUDA) a size above the card count is skipped.
``--dist_backend gloo`` runs several ranks on one card: they share its
compute and stage every collective through host memory, so such rows
measure that the mesh runs, not a speed-up; each row carries its
``backend`` and ``ranks_per_card`` to say so. On the CPU (``--device
cpu``) the ranks are gloo processes sharing the host's cores. Each row
also carries its warm-up loss (the same parameters and batch at every
size) and the kernels' launches on rank 0 over its steps.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

AVG_DEGREE = 27


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="gsrs_tpu_torch.tools.bench_scaling")
    ap.add_argument("--devices", type=int, nargs="+", default=[1])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--n_users", type=int, default=100_000)
    ap.add_argument("--m_items", type=int, default=50_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                    help="the process-group backend of sizes above 1 (default: NCCL on CUDA, "
                    "one rank per card; gloo runs several ranks on one card)")
    return ap


def mesh_axes(n_dev: int):
    """(data, model) of an ``n_dev`` mesh as the JAX tool grows it (pure
    data parallelism, the model axis 2 from 4 ranks), or None with the
    line it prints when the model axis does not divide ``n_dev``."""
    model_axis = 2 if n_dev >= 4 else 1
    if n_dev % model_axis:
        # an odd count would run a smaller mesh than the row reports
        return None, f"# skipping {n_dev} devices (not divisible by model_axis={model_axis})"
    return (n_dev // model_axis, model_axis), None


def measure(device, data_axis: int, model_axis: int, args: dict) -> dict:
    """One mesh size on this rank (a spawned rank, or this process for
    1 × 1) → {"warmup_loss", "step_s", "launches"}."""
    import torch

    from gsrs_tpu_torch.config import ModelConfig, TrainConfig
    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.data.synthetic import powerlaw
    from gsrs_tpu_torch.device import synchronize
    from gsrs_tpu_torch.kernels import launch_counts, launches_since
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.ops.ell import ell_from_interactions
    from gsrs_tpu_torch.ops.sampling import make_sampler_state, sample_triplets
    from gsrs_tpu_torch.parallel.dist_train import make_train_step
    from gsrs_tpu_torch.parallel.mesh import make_mesh
    from gsrs_tpu_torch.parallel.sharding import GraphShardings
    from gsrs_tpu_torch.train.optim import make_optimizer

    data = powerlaw(args["n_users"], args["m_items"], avg_degree=AVG_DEGREE, seed=0)
    mesh = make_mesh(data_axis=data_axis, model_axis=model_axis, device=device)
    model = build_model(ModelConfig(num_layers=args["layers"], embedding_dim=args["dim"],
                                    bf16_compute=True),
                        build_graph(data), ell=ell_from_interactions(data), device=device)
    sh = GraphShardings(mesh)
    sh.place_model(model)
    sh.init_params(model, torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    optimizer, _ = make_optimizer(TrainConfig(lr=1e-3), steps_per_epoch=1)
    opt_state = optimizer.init(params)
    step = make_train_step(model, optimizer, mesh, decay=1e-4)(params, opt_state)
    users, pos, neg = sample_triplets(torch.Generator(device).manual_seed(1),
                                      make_sampler_state(data, device), args["batch"])
    synchronize(device)
    before = launch_counts()
    params, opt_state, loss = step(params, opt_state, users, pos, neg)  # warm-up
    warmup_loss = float(loss)
    t0 = time.time()
    for _ in range(args["steps"]):
        params, opt_state, loss = step(params, opt_state, users, pos, neg)
    float(loss)
    return {"warmup_loss": warmup_loss, "step_s": (time.time() - t0) / args["steps"],
            "launches": launches_since(before)}


def main(argv: Optional[list] = None) -> list:
    """→ the rows printed, each with its size's warm-up loss."""
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)

    import torch

    from gsrs_tpu_torch.device import resolve_device
    from gsrs_tpu_torch.parallel.launch import build_kernels_for, spawn
    from gsrs_tpu_torch.parallel.mesh import choose_backend

    device = resolve_device(args.device)
    build_kernels_for(device.type)
    cards = torch.cuda.device_count() if device.type == "cuda" else None
    work = {k: getattr(args, k) for k in ("n_users", "m_items", "dim", "layers", "batch", "steps")}

    results = []
    base_rate = None
    for n_dev in args.devices:
        backend = choose_backend(args.dist_backend, device.type, 1) if n_dev > 1 else None
        if backend == "nccl" and n_dev > cards:
            print(f"# skipping {n_dev} devices (only {cards})")
            continue
        axes, skip = mesh_axes(n_dev)
        if axes is None:
            print(skip)
            continue
        data_axis, model_axis = axes
        if n_dev == 1:
            out = measure(device, 1, 1, work)
        else:
            out = spawn(measure, n_dev, data_axis, model_axis, work, device_type=device.type,
                        backend=backend)[0]
        dt = out["step_s"]
        rate = args.batch / dt
        if base_rate is None:
            # normalize by the first MEASURED size (requested ones may have been skipped)
            base_rate, base_dev = rate, n_dev
        eff = rate / (base_rate * n_dev / base_dev)
        results.append({
            "devices": n_dev,
            "mesh": f"{data_axis}x{model_axis}",
            "step_ms": round(dt * 1000, 2),
            "examples_per_s": round(rate),
            "scaling_efficiency": round(eff, 3),
            "backend": backend,
            "ranks_per_card": -(-n_dev // cards) if cards else None,
            "warmup_loss": out["warmup_loss"],
            "launches": out["launches"],
        })
        print(json.dumps(results[-1]), flush=True)
    return results


if __name__ == "__main__":
    main()
