"""Pod-scale stress harness (port of ``tools/stress_pod.py``): row-sharded
tables, mesh-sharded ELL edges and the sharded full-catalog top-k.

    # the per-device plan of BASELINE config 5 (50M users × 10M items, dim 256):
    python -m gsrs_tpu_torch.stress_pod --plan_only --chip h100
    # a run on one card:
    python -m gsrs_tpu_torch.stress_pod --n_users 1000000 --m_items 500000 \\
        --data_axis 1 --model_axis 1 --fused_adam pallas
    # the tiny run on a 2 × 2 mesh of gloo ranks (on the CPU, or on one card):
    python -m gsrs_tpu_torch.stress_pod --smoke --device cpu

- ``--plan_only`` prints the per-device memory plan and per-step
  collective volumes for any (scale, mesh) point and whether it fits the
  chip's memory (``--chip``; the H100's 80 GB by default), the JAX
  harness's arithmetic with the H100 added.
- The run mode builds the synthetic graph (the seeded power-law set up
  to 2M users, `big_synthetic` past it), pads it to the model axis,
  places the model with `GraphShardings.place_model` (table rows over
  ``model``, ELL edge slots over the mesh: the ELL gather-reduce kernel
  on each rank's shard, bf16 layers) and times `make_train_step` (the
  fused Adam kernel on each rank's rows under ``--fused_adam pallas``)
  and `make_eval_scores_fn` (the masked-scoring kernel on each rank's
  catalog shard). It prints the JAX harness's JSON lines, the run's peak
  device memory beside the plan's total and the kernels' launch counts,
  then ``STRESS OK``. A mesh of more than one rank, with no process
  group to join, starts its ranks here (`parallel.launch.spawn`), as the
  CLI does; rank 0 prints.

The plan prints before anything is built: sizing a run needs no card.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Optional

HBM_PER_CHIP = {"v5e": 16, "v5p": 95, "v4": 32, "v6e": 32, "h100": 80}  # GiB

# membership-bitset sampler cutoff: past this the run mode (and the
# plan) switch to plain uniform negatives
BITSET_SAMPLER_MAX_BYTES = 8 * 2**30
# --smoke: the JAX harness's tiny scale, on a 2 x 2 mesh
SMOKE = dict(n_users=2000, m_items=1500, dim=32, avg_degree=10, batch=512, eval_batch=128)


def memory_plan(
    n_users: int,
    m_items: int,
    dim: int,
    avg_degree: float,
    batch: int,
    eval_batch: int,
    data_axis: int,
    model_axis: int,
    layers: int = 3,
    chip: str = "h100",
    topk: int = 20,
) -> dict:
    """Per-device byte budget + per-step collective volumes for the
    sharded LightGCN design (tables row-sharded over 'model', edges
    sharded over the full mesh, scores sharded (data, model))."""
    n_dev = data_axis * model_axis
    nodes = n_users + m_items
    edges = int(n_users * avg_degree)

    # fp32 master tables + Adam mu/nu, row-sharded over 'model'
    tables = nodes * dim * 4 * 3 / model_axis
    # propagation working set: bf16 current layer + accumulator + next
    # (ELL SpMM materializes one (nodes, dim) temporary per direction)
    activations = 3 * nodes * dim * 2 / model_axis
    # ELL edges, both directions: idx(4) + weight(4) + perm(4), with
    # ~1.25x power-of-two bucket padding; sharded over the whole mesh
    ell = edges * 2 * 12 * 1.25 / n_dev
    # eval score block: (eval_batch, m_items) fp32 sharded (data, model)
    scores = eval_batch * m_items * 4 / n_dev
    # rejection-sampler membership bitset: (n_users, ceil(m/32)) uint32,
    # REPLICATED per device — beyond bitset_sampler_max_GiB the run mode
    # switches to plain uniform negatives (collision odds ~avg_degree/m)
    sampler_bitset = n_users * ((m_items + 31) // 32) * 4
    use_bitset = sampler_bitset <= BITSET_SAMPLER_MAX_BYTES

    per_dev = tables + activations + ell + scores + (
        sampler_bitset if use_bitset else 0
    )
    hbm = HBM_PER_CHIP[chip] * 2**30

    # collectives per train step
    batch_gather = 3 * batch * dim * 4  # all-to-all: triplet rows from remote shards
    mlp_psum = 0  # table grads stay sharded; only scalar loss + small MLPs psum
    # eval: local top-k (k per shard) then gather-merge over model axis
    topk_merge = eval_batch * topk * 8 * model_axis / n_dev

    min_model_axis = math.ceil((tables + activations) * model_axis / (hbm * 0.8))
    return {
        "devices": n_dev,
        "mesh": f"data={data_axis} x model={model_axis}",
        "chip": chip,
        # Pod scale is ELL-only by design: hybrid's dense hub blocks are
        # O((n+m)·C) with rows REPLICATED per device (hybrid_spec shards
        # only columns), so at these shapes they dwarf any HBM budget —
        # ops.hybrid.resolve_hybrid_cols would clamp them to 0 anyway.
        "spmm": "ell",
        "hybrid_dense_at_C8192_GiB": round(nodes * 8192 * 2 / 2**30, 1),
        "per_device_GiB": {
            "tables+adam": round(tables / 2**30, 3),
            "propagation_activations": round(activations / 2**30, 3),
            "ell_edges": round(ell / 2**30, 3),
            "eval_scores": round(scores / 2**30, 3),
            "sampler_bitset": round(
                (sampler_bitset if use_bitset else 0) / 2**30, 3
            ),
            "total": round(per_dev / 2**30, 3),
        },
        "bitset_sampler": use_bitset,
        "per_step_collectives_MiB": {
            "batch_all_to_all": round(batch_gather / 2**20, 3),
            "grad_psum": round(mlp_psum / 2**20, 3),
            "eval_topk_merge": round(topk_merge / 2**20, 3),
        },
        "fits": per_dev < hbm * 0.8,  # 20% headroom for the framework's temporaries
        "min_model_axis_for_fit": max(1, min_model_axis),
        "edges": edges,
    }


def big_synthetic(n_users: int, m_items: int, avg_degree: int, seed: int = 0):
    """Low-host-memory constant-degree Zipf generator for huge scales:
    no global dedup/sort (parallel edges are numerically harmless — they
    just add weight), int32 ids, chunked sampling."""
    import numpy as np

    from gsrs_tpu_torch.data.dataset import InteractionData

    rng = np.random.default_rng(seed)
    total = n_users * avg_degree
    users = np.repeat(np.arange(n_users, dtype=np.int32), avg_degree)
    items = np.empty(total, dtype=np.int32)
    # Zipf via inverse-CDF on uniform — avoids a 10M-entry choice() p-vector
    s = 1.1
    # The unbounded inverse CDF draws past the catalog for ~35% of draws at
    # these shapes; clamping them onto one rank would give one item a
    # degree of 540k (one degenerate (1, 2^20)-wide ELL bucket). Real
    # catalogs have truncated heads (gowalla's most popular item holds
    # 0.17% of interactions), so out-of-range draws spread uniformly over
    # the whole catalog, and the top HEAD ranks are flattened among
    # themselves, capping every item's share at ≈ P(rank<HEAD)/HEAD ≈
    # 0.46/512 ≈ 0.09% while the tail stays exactly Zipf.
    HEAD = max(1, min(512, m_items // 64))
    for lo in range(0, total, 50_000_000):
        hi = min(lo + 50_000_000, total)
        u = rng.random(hi - lo)
        raw = u ** (-1.0 / (s - 1.0)) - 1.0  # unbounded inverse CDF
        over = ~(raw < float(m_items))  # catches inf/NaN too
        ranks = np.where(over, 0.0, raw).astype(np.int64)
        ranks[over] = rng.integers(0, m_items, int(over.sum()))
        head = ranks < HEAD
        ranks[head & ~over] = rng.integers(0, HEAD, int((head & ~over).sum()))
        items[lo:hi] = ranks.astype(np.int32)
    return InteractionData(
        name=f"stress-{n_users}x{m_items}",
        n_users=n_users,
        m_items=m_items,
        train_users=users.astype(np.int64),
        train_items=items.astype(np.int64),
        test_dict={},
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="gsrs_tpu_torch.stress_pod")
    ap.add_argument("--n_users", type=int, default=50_000_000)
    ap.add_argument("--m_items", type=int, default=10_000_000)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--avg_degree", type=int, default=27)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--eval_batch", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--topk", type=int, default=20)
    ap.add_argument("--data_axis", type=int, default=4)
    ap.add_argument("--model_axis", type=int, default=16)
    ap.add_argument("--chip", choices=sorted(HBM_PER_CHIP), default="h100")
    ap.add_argument("--fused_adam", choices=["off", "pallas"], default="off",
                    help="pallas: the fused Adam kernel on each rank's rows")
    ap.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                    help="the mesh's backend: nccl (one rank per card) or gloo (several ranks "
                         "on one card, or the CPU)")
    ap.add_argument("--device", default=None, help="torch device (default cuda:0)")
    ap.add_argument("--plan_only", action="store_true")
    ap.add_argument("--smoke", action="store_true", help="tiny-scale run on a 2 x 2 mesh")
    return ap


def run(device, args, plan: dict) -> dict:
    """The run mode on this rank (or the one card): build, place, time
    the train step and the sharded eval → the numbers it printed."""
    import numpy as np
    import torch

    from gsrs_tpu_torch.config import ModelConfig, TrainConfig
    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.data.dataset import pad_nodes_to_multiple
    from gsrs_tpu_torch.data.synthetic import powerlaw
    from gsrs_tpu_torch.device import synchronize
    from gsrs_tpu_torch.kernels import launch_counts, launches_since
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.ops.bitset import bitset_to_tensor, build_bitset
    from gsrs_tpu_torch.ops.ell import ell_from_interactions
    from gsrs_tpu_torch.ops.sampling import make_sampler_state, sample_triplets
    from gsrs_tpu_torch.parallel.dist_train import make_eval_scores_fn, make_train_step
    from gsrs_tpu_torch.parallel.mesh import make_mesh
    from gsrs_tpu_torch.parallel.sharding import GraphShardings
    from gsrs_tpu_torch.train.optim import make_optimizer

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device) if cuda else 0
    launches0 = launch_counts()
    build, t0 = {}, time.perf_counter()

    def stage(name: str) -> None:
        nonlocal t0
        synchronize(device)
        build[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    gen = powerlaw if args.n_users <= 2_000_000 else big_synthetic
    data = gen(args.n_users, args.m_items, avg_degree=args.avg_degree, seed=0)
    data = pad_nodes_to_multiple(data, args.model_axis)
    stage("data")
    graph = build_graph(data)
    stage("graph")
    ell = ell_from_interactions(data)
    stage("ell")

    mesh = make_mesh(data_axis=args.data_axis, model_axis=args.model_axis, device=device)
    sh = GraphShardings(mesh)
    model = build_model(ModelConfig(num_layers=args.layers, embedding_dim=args.dim,
                                    bf16_compute=True),
                        graph, ell=ell, device=device, generator=torch.Generator().manual_seed(0))
    if mesh.size > 1:
        sh.place_model(model)
    stage("model")
    optimizer, _ = make_optimizer(TrainConfig(lr=1e-3, fused_adam=args.fused_adam),
                                  steps_per_epoch=1)
    params = dict(model.named_parameters())
    opt_state = optimizer.init(params)
    step = make_train_step(model, optimizer, mesh, decay=1e-4)(params, opt_state)

    bitset_bytes = data.n_users * ((data.m_items + 31) // 32) * 4
    if bitset_bytes <= BITSET_SAMPLER_MAX_BYTES:
        sampler = make_sampler_state(data, device)
        users, pos, neg = sample_triplets(torch.Generator(device).manual_seed(1), sampler,
                                          args.batch)
    else:
        # the membership bitset would need TBs at pod catalog scale: plain
        # uniform negatives (collision probability ~ avg_degree / m_items)
        print(f"# sampler bitset would need {bitset_bytes / 2**30:.0f} GiB; "
              f"using uniform negatives")
        rng = np.random.default_rng(1)
        pick = rng.integers(0, data.train_size, args.batch)
        users, pos, neg = (torch.from_numpy(a.astype(np.int64)).to(device) for a in (
            data.train_users[pick], data.train_items[pick],
            rng.integers(0, data.m_items, args.batch)))
    stage("batch")
    params, opt_state, loss = step(params, opt_state, users, pos, neg)
    float(loss)
    stage("first_step")
    print(json.dumps({"build_s": build}))
    t0 = time.perf_counter()
    for _ in range(args.steps):
        params, opt_state, loss = step(params, opt_state, users, pos, neg)
    loss = float(loss)
    step_s = (time.perf_counter() - t0) / args.steps
    if not math.isfinite(loss):
        raise RuntimeError(f"the stress step's loss is {loss}")
    train = {"train_step_ms": round(step_s * 1000, 2),
             "examples_per_s": round(args.batch / step_s), "loss": loss}
    print(json.dumps(train))

    # sharded full-catalog top-k eval stress
    with torch.no_grad():
        all_u, all_i, _ = sh.call(model, "final_embeddings")
    scores_fn = make_eval_scores_fn(model, mesh)
    eval_user_ids = np.arange(args.eval_batch, dtype=np.int64) % data.n_users
    # bitset rows for just the eval users (remapped to 0..B-1 so the packed
    # table is (B, words), not (n_users, words) — 50M rows won't fit)
    sel = np.isin(data.train_users, eval_user_ids)
    remap = np.full(data.n_users, -1, dtype=np.int64)
    remap[eval_user_ids] = np.arange(args.eval_batch)
    rows = bitset_to_tensor(build_bitset(remap[data.train_users[sel]], data.train_items[sel],
                                         args.eval_batch, data.m_items,
                                         real_m_items=data.real_m_items), device)
    eval_users = torch.from_numpy(eval_user_ids).to(device)
    vals, idx = scores_fn(all_u, all_i, eval_users, rows, args.topk)
    synchronize(device)
    reps = max(1, args.steps // 4)
    t0 = time.perf_counter()
    for _ in range(reps):
        vals, idx = scores_fn(all_u, all_i, eval_users, rows, args.topk)
    synchronize(device)
    eval_s = (time.perf_counter() - t0) / reps
    real_m = data.real_m_items or data.m_items
    if not (bool(torch.isfinite(vals).all()) and int(idx.max()) < real_m):
        raise RuntimeError("the sharded top-k returned a non-finite score or a phantom item")
    evaluation = {"eval_topk_ms": round(eval_s * 1000, 2),
                  "eval_users_per_s": round(args.eval_batch / eval_s)}
    print(json.dumps(evaluation))

    launches = launches_since(launches0)
    peak = (torch.cuda.max_memory_allocated(device) - base) / 2**30 if cuda else None
    memory = {"peak_device_GiB": peak, "plan_total_GiB": plan["per_device_GiB"]["total"],
              "device": torch.cuda.get_device_name(device) if cuda else str(device)}
    print(json.dumps({**memory, "launches": launches}))
    print("STRESS OK")
    return dict(train=train, eval=evaluation, memory=memory, launches=launches,
                build_s=build, edges=data.train_size, rank=mesh.rank,
                top=(vals.cpu(), idx.cpu()))


def main(argv: Optional[list] = None, device=None):
    """``--plan_only`` → the plan; the run mode → the numbers of `run`
    (rank 0's, for a mesh this call starts). ``device`` (or ``--device``)
    defaults to ``cuda:0``."""
    args = build_parser().parse_args(sys.argv[1:] if argv is None else list(argv))
    if args.smoke:
        for k, v in SMOKE.items():
            setattr(args, k, v)
        args.data_axis, args.model_axis = min(args.data_axis, 2), 2

    plan = memory_plan(
        args.n_users, args.m_items, args.dim, args.avg_degree,
        args.batch, args.eval_batch, args.data_axis, args.model_axis,
        layers=args.layers, chip=args.chip, topk=args.topk,
    )
    print(json.dumps(plan, indent=2), flush=True)
    if args.plan_only:
        return plan

    from gsrs_tpu_torch.device import resolve_device
    from gsrs_tpu_torch.parallel.launch import build_kernels_for, spawn
    from gsrs_tpu_torch.parallel.mesh import distributed_init

    device = resolve_device(device if device is not None else args.device)
    n_ranks = args.data_axis * args.model_axis
    if n_ranks > 1 and not distributed_init(args.dist_backend, device.type):
        build_kernels_for(device.type)
        return spawn(run, n_ranks, args, plan, device_type=device.type,
                     backend=args.dist_backend)[0]
    return run(device, args, plan)


if __name__ == "__main__":
    main()
