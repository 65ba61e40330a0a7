"""Serving latency and throughput (port of ``tools/bench_serving.py``).

    python -m gsrs_tpu_torch.tools.bench_serving --checkpoint_dir CK --dataset_dir DS \\
        [--reps 50] [--artifact_dir results] [--device cuda:0]

- Graph retrieval (`gsrs_tpu_torch.serve.Retriever`): p50/p99 request
  latency and users/s at batch 1 and 256, from fp32 and int8 artifacts,
  all made from one propagation of the checkpoint's parameters (random
  ones when the directory holds no checkpoint: latency does not depend
  on them). The model is the one ``CK/model_meta.json`` describes (with
  its i2i graph), else the JAX tool's LightGCN (3 layers, dim 64, bf16).
  The int8 artifact is written to ``--artifact_dir``.
- Sequential retrieval (`gsrs_tpu_torch.serve_seq.SeqRetriever`, SASRec
  with seeded random parameters): sessions at batch 1 and 64.

``ondevice_ms`` is the warm time of one request's score, mask and top-k
on device-resident inputs (`Retriever._score_topk`,
`SeqRetriever._score_topk`): ``iters`` calls queued back to back, one
synchronize. Each row prints the JAX tool's keys and the kernels'
launches over the row's requests and device calls (K1 on every row).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional


def pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p / 100.0 * len(xs)))]


def bench_requests(fn, reqs, warmup=5):
    """fn(request) → latency list (s)."""
    for _ in range(warmup):
        fn(reqs[0])
    lat = []
    for r in reqs:
        t0 = time.perf_counter()
        fn(r)
        lat.append(time.perf_counter() - t0)
    return lat


def _device_of(out):
    import torch

    if isinstance(out, torch.Tensor):
        return out.device
    return next(_device_of(o) for o in out)


def ondevice_ms(call, out0, iters=50):
    """Warm time per call of the zero-argument ``call``: ``iters`` calls
    queued back to back and one synchronize, so the host's wait for each
    result is left out (``out0``, a first result, is waited for first)."""
    from gsrs_tpu_torch.device import synchronize

    device = _device_of(out0)
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    synchronize(device)
    return (time.perf_counter() - t0) / iters * 1e3


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="gsrs_tpu_torch.tools.bench_serving")
    ap.add_argument("--checkpoint_dir", default="checkpoints/b8192-parity")
    ap.add_argument("--dataset_dir", default="data/gowalla")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--artifact_dir", default=None,
                    help="where the int8 artifact is written (default: the repository's results/)")
    ap.add_argument("--device", default=None, help="torch device (default cuda:0)")
    return ap


def _graph_model(args, data, graph, device):
    """The model of ``model_meta.json`` (with its training layout and i2i
    graph), else the JAX tool's configuration."""
    from gsrs_tpu_torch.cli import layout_from_interactions, load_i2i
    from gsrs_tpu_torch.config import ModelConfig
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.serve import model_config_from_meta

    meta_path = os.path.join(args.checkpoint_dir, "model_meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            mcfg = model_config_from_meta(json.load(f))
        print(f"[params] model from {meta_path}")
    else:
        mcfg = ModelConfig(num_layers=3, embedding_dim=64, bf16_compute=True)
    i2i = None
    if mcfg.use_item_item and mcfg.i2i_path:
        i2i = load_i2i(mcfg.i2i_path)
        if i2i is None:
            raise SystemExit(f"the model was trained with the i2i graph {mcfg.i2i_path}, "
                             "which cannot be read")
    return mcfg, build_model(mcfg, graph, i2i, layout_from_interactions(mcfg, data),
                             device=device, cache_dir=args.dataset_dir)


def main(argv: Optional[list] = None):
    """→ (the rows printed, {(quant or family, batch): (the first
    request's ids or sessions, its top-20 items)})."""
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)

    import numpy as np
    import torch

    from gsrs_tpu_torch.config import ExperimentConfig, TrainConfig, _repo_root
    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.data.dataset import load_dataset
    from gsrs_tpu_torch.device import resolve_device
    from gsrs_tpu_torch.kernels import launch_counts, launches_since
    from gsrs_tpu_torch.models.registry import build_seq_model
    from gsrs_tpu_torch.ops.bitset import bitset_to_tensor
    from gsrs_tpu_torch.serve import (
        Retriever, export_embeddings, load_retriever, retriever_from_model,
    )
    from gsrs_tpu_torch.serve_seq import SeqRetriever
    from gsrs_tpu_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    data = load_dataset(args.dataset_dir)
    graph = build_graph(data, cache_dir=args.dataset_dir)
    mcfg, model = _graph_model(args, data, graph, device)
    tcfg = ExperimentConfig(model=mcfg, train=TrainConfig(
        checkpoint_dir=args.checkpoint_dir, resume=True, tensorboard=False))
    tr = Trainer(tcfg, data, graph, model, run_eval=False, device=device)
    state = tr.resume_weights(tr.init_state())
    trained = state.epoch > 0
    print(f"[params] {'restored @ epoch ' + str(state.epoch) if trained else 'RANDOM (latency unaffected)'}")

    # one propagation; every variant is made from the same embeddings
    base = retriever_from_model(model, data, batch_size=256, device=device)
    results, answers = [], {}
    for quant in (None, "int8"):
        if quant is None:
            retr = {1: Retriever(user_emb=base.user_emb, item_emb=base.item_emb,
                                 seen_bitset=base.seen_bitset, batch_size=1, device=device),
                    256: base}
        else:
            out_dir = args.artifact_dir or os.path.join(_repo_root(), "results")
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, "_bench_serving_int8.npz")
            export_embeddings(base, path, quantize="int8")
            retr = {1: load_retriever(path, batch_size=1, device=device),
                    256: load_retriever(path, batch_size=256, device=device)}
        for B, r in retr.items():
            reqs = [rng.integers(0, data.n_users, B).tolist() for _ in range(args.reps)]
            answers[(quant or "fp32", B)] = (reqs[0], r.recommend(reqs[0], k=20)[0])
            before = launch_counts()
            lat = bench_requests(lambda q: r.recommend(q, k=20), reqs)
            # on the device: the same score, mask and top-k on device-resident ids
            ids_dev = torch.as_tensor(np.asarray(reqs[0], np.int64), device=device)
            dev_call = lambda: r._score_topk(ids_dev, 20)
            dev_ms = ondevice_ms(dev_call, dev_call(), iters=args.reps)
            results.append({
                "family": "graph",
                "quant": quant or "fp32",
                "batch": B,
                "p50_ms": round(pct(lat, 50) * 1e3, 2),
                "p99_ms": round(pct(lat, 99) * 1e3, 2),
                "ondevice_ms": round(dev_ms, 3),
                "users_per_s": round(B / pct(lat, 50)),
                "ondevice_users_per_s": round(B / (dev_ms / 1e3)),
                "launches": launches_since(before),
            })
            print(json.dumps(results[-1]), flush=True)

    # ---- sequential (SASRec): latency does not depend on the weights' values
    sm = build_seq_model("sasrec", m_items=data.m_items, max_len=50, dim=64, hidden=64,
                         blocks=2, heads=2, device=device,
                         generator=torch.Generator().manual_seed(0))
    for B in (1, 64):
        sr = SeqRetriever(sm, batch_size=B, device=device)
        sessions = [[rng.integers(0, data.m_items, 20).tolist() for _ in range(B)]
                    for _ in range(args.reps)]
        answers[("seq-sasrec", B)] = (sessions[0], sr.recommend(sessions[0], k=20)[0])
        before = launch_counts()
        lat = bench_requests(lambda s: sr.recommend(s, k=20), sessions)
        seqs0, seen0 = sr._encode_sessions(sessions[0])
        seqs_dev = torch.from_numpy(seqs0).long().to(device)
        seen_dev = bitset_to_tensor(seen0, device)
        dev_call = lambda: sr._score_topk(seqs_dev, seen_dev, 20)
        dev_ms = ondevice_ms(dev_call, dev_call(), iters=args.reps)
        results.append({
            "family": "seq-sasrec",
            "quant": "fp32",
            "batch": B,
            "p50_ms": round(pct(lat, 50) * 1e3, 2),
            "p99_ms": round(pct(lat, 99) * 1e3, 2),
            "ondevice_ms": round(dev_ms, 3),
            "sessions_per_s": round(B / pct(lat, 50)),
            "ondevice_sessions_per_s": round(B / (dev_ms / 1e3)),
            "launches": launches_since(before),
        })
        print(json.dumps(results[-1]), flush=True)

    print(json.dumps({"summary": results}))
    return results, answers


if __name__ == "__main__":
    main()
