"""Training epochs and an eval at the yelp2018 and amazon-book shapes, on
power-law stand-ins (port of ``tools/bench_scale_standin.py``).

    python -m gsrs_tpu_torch.tools.bench_scale_standin [--spmm ell hybrid] \\
        [--batch 2048 8192] [--shapes yelp2018-scale amazon-book-scale] \\
        [--timed_epochs 2] [--hybrid_cols 8192] [--timeout 1800] [--device cuda:0]

The reference publishes quality tables for yelp2018 (31,668 × 38,048)
and amazon-book (52,643 × 91,599), whose train.txt files are not in the
snapshot; this harness runs the framework at those shapes with
`stress_pod.big_synthetic` graphs of the same interaction counts
(`SHAPES`) and 10 random held-out items a user. Each (shape, spmm, batch)
runs in its own subprocess (``--single``): LightGCN, 3 layers, dim 64,
bf16, on the ELL layout or the hybrid one (dense hub blocks of
``--hybrid_cols`` columns + a residual ELL); a warm-up epoch, then
``--timed_epochs`` epochs on the host clock; an `Evaluator` run twice,
the second timed. Each row prints the JAX tool's keys (``hbm_gib_in_use``
is `torch.cuda.memory_allocated` of the card; None on the CPU), the bytes
of the model's parameters and of its layout's tensors, and the kernels'
launches over its epochs and evals (K4 in every propagation, K1 on every
eval batch). A config whose subprocess fails or outlasts ``--timeout``
prints the JAX tool's ``"result": "FAILED"`` row and the sweep goes on;
the sweep then exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from typing import Optional

SHAPES = {
    # avg_degree chosen to match the real datasets' interaction counts:
    # yelp2018 ~1.56M over 31,668 users (~49), amazon-book ~2.98M over
    # 52,643 users (~57) (reference data READMEs / SURVEY C21)
    "yelp2018-scale": dict(n_users=31668, m_items=38048, avg_degree=49),
    "amazon-book-scale": dict(n_users=52643, m_items=91599, avg_degree=57),
}


def held_out_standin(n_users: int, m_items: int, avg_degree: int):
    """`stress_pod.big_synthetic(seed=0)` at a shape, with 10 random
    held-out items a user drawn from ``default_rng(1)`` (eval cost depends
    on the test users and the catalog, not on which items are held out)."""
    import numpy as np

    from gsrs_tpu_torch.stress_pod import big_synthetic

    data = big_synthetic(n_users, m_items, avg_degree=avg_degree, seed=0)
    rng = np.random.default_rng(1)
    td = {int(u): rng.integers(0, data.m_items, 10) for u in range(data.n_users)}
    return dataclasses.replace(data, test_dict=td)


def device_mem_gib(device) -> Optional[float]:
    """GiB allocated on the card (the JAX tool's ``bytes_in_use``); None on
    the CPU."""
    import torch

    if device.type != "cuda":
        return None
    return round(torch.cuda.memory_allocated(device) / 2**30, 2)


def tensor_bytes(obj) -> int:
    """The bytes of every tensor in ``obj`` (a tensor, a dataclass, or a
    list, tuple or dict of them)."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(tensor_bytes(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    if isinstance(obj, (list, tuple)):
        return sum(tensor_bytes(v) for v in obj)
    if isinstance(obj, dict):
        return sum(tensor_bytes(v) for v in obj.values())
    return 0


def build_parser(single: bool) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="gsrs_tpu_torch.tools.bench_scale_standin")
    if single:
        ap.add_argument("--single", action="store_true")
    ap.add_argument("--spmm", nargs="+", default=["ell", "hybrid"])
    ap.add_argument("--batch", type=int, nargs="+", default=[2048, 8192])
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES))
    ap.add_argument("--timed_epochs", type=int, default=2)
    ap.add_argument("--hybrid_cols", type=int, default=8192)
    if not single:
        ap.add_argument(
            "--timeout", type=int, default=1800,
            help="per-config subprocess timeout (s); amazon-book-scale b2048 "
            "runs ~1450 steps/epoch x 3 epochs",
        )
    ap.add_argument("--device", default=None, help="torch device (default cuda:0)")
    return ap


def drive(argv: Optional[list] = None) -> list:
    """Every (shape, spmm, batch) in its own subprocess → the rows they
    printed, a FAILED row for each config that failed; raises SystemExit
    (non-zero) at the end when any did."""
    from gsrs_tpu_torch.config import _repo_root

    args = build_parser(single=False).parse_args(sys.argv[1:] if argv is None else argv)
    rows, failed = [], []
    for shape in args.shapes:
        for spmm in args.spmm:
            for b in args.batch:
                cmd = [
                    sys.executable, "-m", "gsrs_tpu_torch.tools.bench_scale_standin", "--single",
                    "--shapes", shape, "--spmm", spmm, "--batch", str(b),
                    "--timed_epochs", str(args.timed_epochs),
                    "--hybrid_cols", str(args.hybrid_cols),
                ] + (["--device", args.device] if args.device else [])
                try:
                    r = subprocess.run(cmd, cwd=_repo_root(), stdout=subprocess.PIPE, text=True,
                                       timeout=args.timeout)
                    out, ok = r.stdout, r.returncode == 0
                except subprocess.TimeoutExpired as e:
                    out, ok = e.stdout or "", False
                    if isinstance(out, bytes):
                        out = out.decode()
                print(out, end="", flush=True)
                rows += [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
                if not ok:
                    rows.append({"shape": shape, "spmm": spmm, "batch": b, "attempt": 1,
                                 "result": "FAILED"})
                    failed.append(rows[-1])
                    print(json.dumps(rows[-1]), flush=True)
    if failed:
        raise SystemExit(f"bench_scale_standin: {len(failed)} config(s) failed: {failed}")
    return rows


def main(argv: Optional[list] = None) -> list:
    """The ``--single`` run: every (shape, spmm, batch) given, in this
    process → the rows printed."""
    args = build_parser(single=True).parse_args(sys.argv[1:] if argv is None else argv)

    import torch

    from gsrs_tpu_torch.config import EvalConfig, ExperimentConfig, ModelConfig, TrainConfig
    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.device import resolve_device
    from gsrs_tpu_torch.kernels import launch_counts, launches_since
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.ops.ell import ell_from_interactions
    from gsrs_tpu_torch.ops.hybrid import hybrid_from_interactions
    from gsrs_tpu_torch.train.evaluator import Evaluator
    from gsrs_tpu_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    rows = []
    for shape_name in args.shapes:
        data = held_out_standin(**SHAPES[shape_name])
        graph = build_graph(data)
        for spmm in args.spmm:
            mcfg = ModelConfig(
                num_layers=3, embedding_dim=64, bf16_compute=True,
                spmm_mode=spmm, hybrid_cols=args.hybrid_cols,
            )
            if spmm == "hybrid":
                layout = hybrid_from_interactions(data, cols=args.hybrid_cols,
                                                  dtype=torch.bfloat16)
            else:
                layout = ell_from_interactions(data)
            for B in args.batch:
                cfg = ExperimentConfig(
                    model=mcfg,
                    train=TrainConfig(batch_size=B, tensorboard=False),
                    eval=EvalConfig(test_batch=2048, topks=(20,)),
                )
                model = build_model(mcfg, graph, ell=layout, device=device)
                trainer = Trainer(cfg, data, graph, model, run_eval=False, device=device)
                before = launch_counts()
                state = trainer.init_state()
                state, _ = trainer.train_epoch(state)  # warm-up
                t0 = time.time()
                for _ in range(args.timed_epochs):
                    state, loss = trainer.train_epoch(state)  # reads the loss: ends synchronized
                epoch_s = (time.time() - t0) / args.timed_epochs

                ev = Evaluator(data, model, cfg.eval, device=device)
                ev.run()  # warm
                t0 = time.time()
                ev.run()  # reads its sums: ends synchronized
                eval_s = time.time() - t0

                rows.append({
                    "shape": shape_name,
                    "spmm": spmm,
                    "batch": B,
                    "train_epoch_s": round(epoch_s, 3),
                    "eval_s": round(eval_s, 3),
                    "eval_users_per_s": round(ev.n_test_users / eval_s),
                    "hbm_gib_in_use": device_mem_gib(device),
                    "edges": int(data.train_users.size),
                    "params_bytes": tensor_bytes(list(model.parameters())),
                    "layout_bytes": tensor_bytes(model.ell),
                    "launches": launches_since(before),
                })
                print(json.dumps(rows[-1]), flush=True)
                del trainer, state, ev, model
    return rows


if __name__ == "__main__":
    if "--single" in sys.argv:
        main()
    else:
        drive()
