"""Command-line training (port of `gsrs_tpu.cli`).

The JAX package's whole flag surface, with its names and defaults, mapped
onto the same config dataclasses; then data, graph, layout, model and
`Trainer.fit` with its checkpoints and logs. Runs on ``cuda:0`` and
raises when there is no card; `main`'s ``device`` keyword lets a caller
(the tests) ask for the CPU.

    python -m gsrs_tpu_torch --dataset gowalla --epochs 1000 --bf16

Every model (``--model lgn|mf|ngcf|xsimgcl|ultragcn``) and layout
(``--spmm ell|tiled|hybrid|segment``) of the JAX package runs, on one
card or on a ``--data_axis D --model_axis M`` mesh: with no process group
to join (`gsrs_tpu_torch.parallel.mesh.distributed_init`), the command
builds the kernels and starts the D · M ranks on this host itself
(`gsrs_tpu_torch.parallel.launch.spawn`), NCCL with one rank per card or,
with ``--dist_backend gloo``, several ranks on one card. The data is
padded to a multiple of M nodes as the JAX CLI pads it. Flags the JAX
package accepts and ignores (``--a_fold``, ``--A_split``, ``--multicore``,
the PPR flags) are accepted and ignored.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

from gsrs_tpu_torch.config import (
    DataConfig,
    EvalConfig,
    ExperimentConfig,
    ModelConfig,
    ParallelConfig,
    TrainConfig,
    milestones_from_string,
    topks_from_string,
)
from gsrs_tpu_torch.device import DeviceLike


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gsrs_tpu_torch",
        description="Graph recommendation training (the LightGCN family) on a CUDA card",
    )
    # core training
    p.add_argument("--bpr_batch", type=int, default=2048)
    p.add_argument("--recdim", type=int, default=64)
    p.add_argument("--layer", type=int, default=3)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--decay", type=float, default=1e-4)
    p.add_argument("--dropout", type=int, default=0)
    p.add_argument("--keepprob", type=float, default=0.6)
    p.add_argument("--a_fold", type=int, default=100, help="accepted and ignored")
    p.add_argument("--A_split", action="store_true", help="accepted and ignored")
    p.add_argument(
        "--reg_mode", choices=["propagated", "ego"], default="propagated",
        help="L2 target: 'propagated' = the propagated batch rows; 'ego' = the raw table rows",
    )
    p.add_argument("--testbatch", type=int, default=2048)
    p.add_argument("--epochs", type=int, default=1000)
    # dataset / paths
    p.add_argument("--dataset", type=str, default="gowalla")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--checkpoint_dir", type=str, default="./checkpoints")
    p.add_argument("--topks", type=str, default="[20]")
    # logging / repro
    p.add_argument("--tensorboard", type=int, default=1)
    p.add_argument("--comment", type=str, default="lgn")
    p.add_argument("--load", type=int, default=0)
    p.add_argument("--pretrain", type=int, default=0)
    p.add_argument("--seed", type=int, default=2020)
    p.add_argument("--model", type=str, default="lgn",
                   choices=["lgn", "mf", "ngcf", "xsimgcl", "ultragcn"])
    p.add_argument("--multicore", type=int, default=0, help="accepted and ignored")
    # PPR layer weights: accepted and ignored
    p.add_argument("--exp_smooth_beta", type=float, default=0.0)
    p.add_argument("--use_ppr_weights", action="store_true")
    p.add_argument("--ppr_weights_path", type=str, default=None)
    # scheduler
    p.add_argument("--use_scheduler", action="store_true")
    p.add_argument("--sched_milestones", type=str, default="[120,240,360,480]")
    p.add_argument("--sched_gamma", type=float, default=0.5)
    # pop gate
    p.add_argument("--use_pop_gate", action="store_true")
    p.add_argument("--pop_hidden", type=int, default=32)
    p.add_argument("--gate_hidden", type=int, default=64)
    p.add_argument("--gate_entropy_coeff", type=float, default=1e-4)
    p.add_argument("--pop_gate_temp", type=float, default=1.0)
    # item-item smoothing
    p.add_argument("--use_item_item", action="store_true")
    p.add_argument("--i2i_path", type=str, default=None)
    p.add_argument("--i2i_alpha", type=float, default=0.1)
    # checkpoint / resume
    p.add_argument("--resume", action="store_true")
    p.add_argument("--resume_path", type=str, default=None)
    p.add_argument("--save_every", type=int, default=10)
    p.add_argument("--keep_topk", type=int, default=0)
    # XSimGCL flags (model=xsimgcl)
    p.add_argument("--cl_lambda", type=float, default=0.2)
    p.add_argument("--cl_temp", type=float, default=0.2)
    p.add_argument("--cl_eps", type=float, default=0.2)
    p.add_argument("--cl_layer", type=int, default=1)
    # UltraGCN flags (model=ultragcn)
    p.add_argument("--ug_neg_num", type=int, default=1500)
    p.add_argument("--ug_neg_weight", type=float, default=300.0)
    p.add_argument("--ug_w1", type=float, default=1e-6)
    p.add_argument("--ug_w2", type=float, default=1.0)
    p.add_argument("--ug_w3", type=float, default=1e-6)
    p.add_argument("--ug_w4", type=float, default=1.0)
    p.add_argument("--ug_lambda", type=float, default=2.75)
    p.add_argument("--ug_ii_k", type=int, default=10)
    p.add_argument("--ug_init_std", type=float, default=1e-4)
    p.add_argument("--ug_neg_sharing", type=str, default="none",
                   choices=["none", "batch", "group", "full", "pool"])
    p.add_argument("--ug_neg_groups", type=int, default=8)
    p.add_argument("--ug_neg_pool", type=int, default=8192)
    p.add_argument("--ug_sift_pos", action="store_true")
    # layouts and numerics
    p.add_argument("--bf16", action="store_true", help="bf16 propagation")
    p.add_argument("--spmm", type=str, default="ell",
                   choices=["ell", "hybrid", "tiled", "segment"],
                   help="propagation layout: ell (bucketed ELL through the CUDA gather-reduce), "
                   "tiled (per-row-group hub blocks over a spectral order + residual ELL), "
                   "hybrid (hub-column dense blocks + residual ELL) or segment (the JAX "
                   "package's segment sums over the sorted edge lists: the same sums, run "
                   "here on the ELL layout)")
    p.add_argument("--hybrid_cols", type=int, default=8192)
    p.add_argument("--tiled_groups", type=int, default=32,
                   help="row groups per direction for --spmm tiled")
    p.add_argument("--tiled_cols", type=int, default=4096,
                   help="hub columns per row group for --spmm tiled")
    p.add_argument("--eval_every", type=int, default=10)
    p.add_argument("--early_stop", type=int, default=0,
                   help="stop after N evals with no NDCG improvement (0 = off)")
    p.add_argument("--topk_method", type=str, default="exact",
                   choices=["exact", "approx", "threshold"],
                   help="eval top-k: exact (lax.top_k's order), approx (the TPU's approx_max_k fold, "
                   "recall >= --topk_recall_target in expectation) or threshold (exact "
                   "threshold selection)")
    p.add_argument("--topk_recall_target", type=float, default=0.98)
    p.add_argument("--use_pallas_scoring", nargs="?", const="on", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="'on' scores eval batches in the bit-plane layout of the masked-"
                   "scoring kernel; 'auto' and 'off' in natural order")
    p.add_argument("--epoch_samples", type=int, default=0,
                   help="override #triplets per epoch (0 = train_size)")
    p.add_argument("--neg_candidates", type=int, default=16,
                   help="device sampler: negative candidates per triplet")
    p.add_argument("--save_last_every", type=int, default=1,
                   help="cadence (epochs) of the rolling 'last' checkpoint; 1 = every epoch")
    p.add_argument("--fused_adam", choices=["off", "jnp", "pallas"], default="off",
                   help="off = torch.optim.Adam; jnp = one fused update per table in torch "
                   "ops; pallas = the fused Adam CUDA kernel")
    p.add_argument("--data_axis", type=int, default=1)
    p.add_argument("--model_axis", type=int, default=1)
    add_backend_flag(p)
    return p


def add_backend_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                   help="a mesh's process-group backend: nccl (default on CUDA: one rank per "
                   "card) or gloo (the CPU; several ranks on one card)")


def config_from_args(args: argparse.Namespace) -> ExperimentConfig:
    # the data_root default lives in DataConfig's factory
    data_kw = {"data_root": args.data_root} if args.data_root else {}
    return ExperimentConfig(
        data=DataConfig(dataset=args.dataset, **data_kw),
        model=ModelConfig(
            model=args.model,
            embedding_dim=args.recdim,
            num_layers=args.layer,
            dropout=bool(args.dropout),
            keep_prob=args.keepprob,
            a_split=args.A_split,
            a_fold=args.a_fold,
            reg_mode=args.reg_mode,
            use_pop_gate=args.use_pop_gate,
            pop_hidden=args.pop_hidden,
            gate_hidden=args.gate_hidden,
            gate_entropy_coeff=args.gate_entropy_coeff,
            pop_gate_temp=args.pop_gate_temp,
            use_item_item=args.use_item_item,
            i2i_path=args.i2i_path,
            i2i_alpha=args.i2i_alpha,
            use_ppr_weights=args.use_ppr_weights,
            ppr_weights_path=args.ppr_weights_path,
            exp_smooth_beta=args.exp_smooth_beta,
            cl_lambda=args.cl_lambda,
            cl_temp=args.cl_temp,
            cl_eps=args.cl_eps,
            cl_layer=args.cl_layer,
            ug_neg_num=args.ug_neg_num,
            ug_neg_weight=args.ug_neg_weight,
            ug_w1=args.ug_w1,
            ug_w2=args.ug_w2,
            ug_w3=args.ug_w3,
            ug_w4=args.ug_w4,
            ug_lambda=args.ug_lambda,
            ug_ii_k=args.ug_ii_k,
            ug_init_std=args.ug_init_std,
            ug_neg_sharing=args.ug_neg_sharing,
            ug_neg_groups=args.ug_neg_groups,
            ug_neg_pool=args.ug_neg_pool,
            ug_sift_pos=args.ug_sift_pos,
            bf16_compute=args.bf16,
            spmm_mode=args.spmm,
            hybrid_cols=args.hybrid_cols,
            tiled_groups=args.tiled_groups,
            tiled_cols=args.tiled_cols,
        ),
        train=TrainConfig(
            batch_size=args.bpr_batch,
            lr=args.lr,
            decay=args.decay,
            epochs=args.epochs,
            seed=args.seed,
            use_scheduler=args.use_scheduler,
            sched_milestones=milestones_from_string(args.sched_milestones),
            sched_gamma=args.sched_gamma,
            checkpoint_dir=args.checkpoint_dir,
            save_every=args.save_every,
            keep_topk=args.keep_topk,
            resume=args.resume,
            resume_path=args.resume_path,
            load_pretrained=bool(args.load),
            pretrain=args.pretrain,
            eval_every=args.eval_every,
            early_stop_evals=args.early_stop,
            tensorboard=bool(args.tensorboard),
            comment=args.comment,
            neg_candidates=args.neg_candidates,
            save_last_every=args.save_last_every,
            fused_adam=args.fused_adam,
        ),
        eval=EvalConfig(
            test_batch=args.testbatch,
            topks=topks_from_string(args.topks),
            multicore=bool(args.multicore),
            topk_method=args.topk_method,
            topk_recall_target=args.topk_recall_target,
            use_pallas_scoring=args.use_pallas_scoring,
        ),
        parallel=ParallelConfig(data_axis=args.data_axis, model_axis=args.model_axis),
    )


def launch_if_needed(entry, argv, n_ranks: int, backend: Optional[str], device) -> bool:
    """For a mesh of ``n_ranks`` > 1 with no process group to join: build
    the kernels and run ``entry(device, argv)`` in ``n_ranks`` ranks on
    this host → True when it did (the caller is done); False when this
    process is a rank already, or there is no mesh."""
    from gsrs_tpu_torch.device import resolve_device
    from gsrs_tpu_torch.parallel.launch import build_kernels_for, spawn
    from gsrs_tpu_torch.parallel.mesh import distributed_init

    device = resolve_device(device)
    if n_ranks <= 1 or distributed_init(backend, device.type):
        return False
    build_kernels_for(device.type)
    spawn(entry, n_ranks, argv, device_type=device.type, backend=backend)
    return True


def _rank_entry(device, argv) -> None:
    main(argv, device=device)


def load_i2i(path: str):
    """The `ItemItemGraph` of an i2i npz, or None with a warning when it
    cannot be read (the run then trains without smoothing, as the JAX
    package's does)."""
    import zipfile

    import scipy.sparse as sp

    from gsrs_tpu_torch.models.lightgcn import ItemItemGraph

    try:
        mat = sp.load_npz(path)
    except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
        print(f"[i2i] WARNING: cannot load {path}: {e}")
        return None
    print(f"[i2i] loaded {path}")
    return ItemItemGraph.from_scipy(mat)


def layout_from_interactions(cfg: ModelConfig, data):
    """The propagation layout of ``cfg.spmm_mode`` built from the dataset
    (the segment layout is the ELL one), or None where the model
    propagates nothing (mf, ultragcn)."""
    import torch

    from gsrs_tpu_torch.ops.ell import ell_from_interactions
    from gsrs_tpu_torch.ops.hybrid import hybrid_from_interactions
    from gsrs_tpu_torch.ops.tiled import tiled_from_interactions

    if cfg.model in ("mf", "ultragcn") or cfg.num_layers == 0:
        return None
    dtype = torch.bfloat16 if cfg.bf16_compute else torch.float32
    if cfg.spmm_mode == "tiled":
        return tiled_from_interactions(data, groups=cfg.tiled_groups, cols=cfg.tiled_cols,
                                       dtype=dtype)
    if cfg.spmm_mode == "hybrid":
        return hybrid_from_interactions(data, cols=cfg.hybrid_cols, dtype=dtype)
    return ell_from_interactions(data)


def main(argv: Optional[list] = None, device: DeviceLike = None):
    """Train as the flags say → (the `Trainer`, the final `TrainState`);
    the trainer's model holds the final parameters. ``device`` defaults
    to ``cuda:0``. A mesh started here (see the module docstring) returns
    None once every rank has finished; in a rank, ``device`` is the
    rank's."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if launch_if_needed(_rank_entry, argv, args.data_axis * args.model_axis,
                        args.dist_backend, device):
        return None

    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.data.dataset import load_dataset, load_lastfm
    from gsrs_tpu_torch.device import resolve_device
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.train.trainer import Trainer
    from gsrs_tpu_torch.utils.seeding import set_seed

    device = resolve_device(device)
    set_seed(args.seed)
    if args.dataset == "lastfm":
        data = load_lastfm(cfg.data.dataset_dir)
    else:
        data = load_dataset(cfg.data.dataset_dir, name=args.dataset)
    print(f"[data] {data.name}: {data.n_users} users × {data.m_items} items, "
          f"{data.train_size} train interactions, {len(data.test_dict)} test users")
    if cfg.parallel.model_axis > 1:
        from gsrs_tpu_torch.data.dataset import pad_nodes_to_multiple

        # row-sharded tables split evenly over the model axis
        data = pad_nodes_to_multiple(data, cfg.parallel.model_axis)
    graph = build_graph(data, edge_pad_multiple=cfg.data.edge_pad_multiple,
                        cache_dir=cfg.data.dataset_dir if cfg.data.cache_adjacency else None)
    i2i = None
    if cfg.model.use_item_item and cfg.model.i2i_path:
        i2i = load_i2i(cfg.model.i2i_path)
    model = build_model(cfg.model, graph, i2i, layout_from_interactions(cfg.model, data),
                        device=device, cache_dir=cfg.data.dataset_dir)
    trainer = Trainer(cfg, data, graph, model, device=device)
    if args.epoch_samples:
        trainer.epoch_samples = args.epoch_samples
    state = trainer.fit(log_dir=os.path.join(cfg.train.checkpoint_dir, "runs"))
    return trainer, state


if __name__ == "__main__":
    main()
