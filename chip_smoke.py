#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`gsrs_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py          # from the repository root; needs one CUDA card

1. Prints the card's name and power limit, and turns TF32 off.
2. Builds every CUDA kernel of the serving path from ``gsrs_tpu_torch/csrc``.
3. Kernel phase: each kernel against its plain PyTorch version on the
   card, in both layouts, at the serving shape (256 × 64 × 40,981), at
   B = 13 and at m = 100, with random bitsets.
4. Serving phase, LightGCN at Gowalla's shape (a seeded power-law
   stand-in: 29,858 users × 40,981 items, average degree 27), 3 layers at
   dim 64, fp32, seeded weights: build the graph, propagate, build the
   Retriever and answer 4 requests of 256 users with top-20, in the
   natural and the bit-plane layout. The launch counters are zeroed just
   before and read just after; the results are checked against the plain
   path on the card, and an npz export → load round trip must be
   identical.
5. Times the kernels (CUDA events, after a warm-up) beside their bound,
   the plain version and one PyTorch call, and the request latency, the
   device's busy share during requests (torch.profiler), the propagation
   time and peak device memory.

Prints ``{"kernels": [...]}`` on the line before the last and, as the
last line, ``{"ok": true, "device": {...}}``. Any failed check raises and
the script exits non-zero; without a CUDA card it exits 2 and prints no
result. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

SEED = 2020
GOWALLA_SHAPE = dict(n_users=29858, m_items=40981, avg_degree=27)
BATCH, K, N_REQUESTS = 256, 20, 4
ATOL = 1e-4  # kernel vs plain: fp32 sums in another order, |score| ≲ 30
SWAP_TOL = 1e-5  # top-k boundary ties the two orders may rank either way
# published H100 SXM peaks at a 700 W power limit (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
KERNEL_SOURCE = "gsrs_tpu_torch/csrc/masked_scores.cu"
REPLACES = {
    "masked_scores": "gsrs_tpu/ops/pallas_kernels.py:65",
    "masked_scores_bitplane": "gsrs_tpu/ops/pallas_kernels.py:190",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 5) -> float:
    """Mean device milliseconds per call of ``fn`` over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(B: int, d: int, m: int, W: int):
    """(bound_ms, bound_by) of one masked-scoring call on (B, d) users,
    (m, d) items and (B, W) bitset words: inputs read once, the (B, m)
    output written once, 2·B·m·d fp32 operations."""
    nbytes = 4 * (B * d + m * d + B * W + B * m)
    flops = 2 * B * m * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


# ------------------------------------------------------------- kernel phase


def compare(got: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    """Identical mask positions, other scores within ATOL → max abs error."""
    from gsrs_tpu_torch.ops.scoring import NEG_INF

    check(got.shape == ref.shape, f"{what}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite scores")
    gm, rm = got == NEG_INF, ref == NEG_INF
    check(bool((gm == rm).all()), f"{what}: mask positions differ")
    err = float((got - ref).abs().masked_fill(rm, 0).max()) if got.numel() else 0.0
    check(err <= ATOL, f"{what}: max abs error {err} > {ATOL}")
    return err


def kernel_phase(dev: torch.device) -> dict:
    """Kernel vs plain version in both layouts → {kernel: max abs error
    at the serving shape}."""
    from gsrs_tpu_torch.ops.scoring import masked_scores, masked_scores_reference

    g = torch.Generator(device=dev).manual_seed(SEED)
    errs = {}
    for B, d, m in ((BATCH, 64, GOWALLA_SHAPE["m_items"]), (13, 64, 40981), (BATCH, 64, 100)):
        for bitplane in (False, True):
            block_m = 4096
            rows = -(-m // block_m) * block_m if bitplane else m
            W = rows // 32 if bitplane else -(-m // 32)
            u = torch.randn(B, d, device=dev, generator=g)
            it = torch.randn(rows, d, device=dev, generator=g)
            bits = torch.randint(-2**31, 2**31, (B, W), device=dev, generator=g,
                                 dtype=torch.int64).to(torch.int32)
            got = masked_scores(u, it, bits, bitplane=bitplane, block_m=block_m)
            ref = masked_scores_reference(u, it, bits, bitplane=bitplane, block_m=block_m)
            torch.cuda.synchronize()
            name = "masked_scores_bitplane" if bitplane else "masked_scores"
            err = compare(got, ref, f"{name} B={B} d={d} m={m}")
            log(f"[kernel] {name:24s} B={B:3d} d={d} m={m:5d}: max abs err {err:.3e}")
            if (B, m) == (BATCH, GOWALLA_SHAPE["m_items"]):
                errs[name] = err
    torch.cuda.synchronize()
    return errs


# ------------------------------------------------------------ serving phase


def same_topk(items, plain_scores: torch.Tensor, ref_items, what: str) -> None:
    """Equal top-k ids, except swaps of items whose plain scores differ
    by less than SWAP_TOL."""
    items = torch.as_tensor(np.asarray(items), dtype=torch.int64, device=plain_scores.device)
    ref = torch.as_tensor(np.asarray(ref_items), dtype=torch.int64, device=plain_scores.device)
    diff = items != ref
    if bool(diff.any()):
        gap = (plain_scores.gather(1, items) - plain_scores.gather(1, ref)).abs()
        worst = float(gap[diff].max())
        check(worst < SWAP_TOL, f"{what}: top-k differs beyond ties (score gap {worst})")
        log(f"[serve] {what}: {int(diff.sum())} boundary swaps, gap ≤ {worst:.2e}")


def serving_phase(dev: torch.device, shape: dict, out_dir: str) -> dict:
    from gsrs_tpu_torch.config import ModelConfig
    from gsrs_tpu_torch.data import synthetic
    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.ops import scoring
    from gsrs_tpu_torch.ops.ell import ell_from_interactions
    from gsrs_tpu_torch.ops.scoring import masked_scores_reference
    from gsrs_tpu_torch.serve import (
        Retriever, export_embeddings, load_retriever, retriever_from_model,
    )

    data = synthetic.powerlaw(shape["n_users"], shape["m_items"],
                              avg_degree=shape["avg_degree"], seed=SEED)
    users = np.random.default_rng(SEED).choice(data.n_users, BATCH * N_REQUESTS, replace=False)
    batches = [users[i * BATCH:(i + 1) * BATCH] for i in range(N_REQUESTS)]
    log(f"[serve] data {data.n_users} users x {data.m_items} items, {data.train_size} edges")

    # ---- the main path, counted: graph → model → propagation → retriever → requests
    for name in scoring.LAUNCHES:
        scoring.LAUNCHES[name] = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    graph = build_graph(data)
    ell = ell_from_interactions(data)
    t_graph = time.perf_counter() - t0
    model = build_model(ModelConfig(num_layers=3, embedding_dim=64), graph, ell=ell,
                        device=dev, generator=torch.Generator().manual_seed(SEED))
    t0 = time.perf_counter()
    retriever = retriever_from_model(model, data, batch_size=BATCH, device=dev)
    torch.cuda.synchronize()
    t_retriever = time.perf_counter() - t0
    natural = [retriever.recommend(b, k=K) for b in batches]
    bitplane = Retriever(retriever.user_emb, retriever.item_emb, retriever.seen_bitset,
                         batch_size=BATCH, use_pallas_scoring="on", device=dev)
    planes = [bitplane.recommend(b, k=K) for b in batches]
    torch.cuda.synchronize()
    launches = dict(scoring.LAUNCHES)
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    log(f"[serve] graph+ELL build {t_graph:.3f} s, retriever_from_model {t_retriever:.3f} s, "
        f"launches {launches}")
    for name, n in launches.items():
        check(n >= N_REQUESTS, f"{name} launched {n} times on the main path")

    # ---- checks against the plain path on the card
    net = data.user_item_net
    ue, ie, seen = retriever._serve_tables
    for b, (items, scores), (bp_items, bp_scores) in zip(batches, natural, planes):
        check(items.shape == (BATCH, K) and np.isfinite(scores).all(), "bad result shape/values")
        check(bool(((items >= 0) & (items < data.m_items)).all()), "item id out of range")
        seen_hits = np.asarray(net[np.repeat(b, K), items.ravel()]).ravel()
        check(not seen_hits.any(), "a train positive was recommended")
        ids = torch.as_tensor(b, device=dev)
        plain = masked_scores_reference(ue[ids], ie, seen[ids])
        p_scores, p_items = torch.topk(plain, K, dim=1)
        check(np.allclose(scores, p_scores.cpu().numpy(), atol=ATOL), "top-k scores differ")
        same_topk(items, plain, p_items.cpu().numpy(), "natural vs plain")
        same_topk(bp_items, plain, items, "bit-plane vs natural")
        check(np.allclose(bp_scores, scores, atol=ATOL), "bit-plane scores differ")

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "smoke_emb.npz")
    export_embeddings(retriever, path)
    loaded = load_retriever(path, batch_size=BATCH, device=dev)
    for b, (items, scores) in zip(batches, natural):
        items2, scores2 = loaded.recommend(b, k=K)
        check(np.array_equal(items, items2) and np.array_equal(scores, scores2),
              "npz round trip changed the recommendations")
    q8 = os.path.join(out_dir, "smoke_emb_q8.npz")
    export_embeddings(retriever, q8, quantize="int8")
    rq = load_retriever(q8, batch_size=BATCH, device=dev)
    uq, iq, _ = rq._serve_tables
    ids = torch.as_tensor(batches[0], device=dev)
    raw = masked_scores_reference(uq[ids], iq, seen[ids])
    plain_q = torch.where(raw == scoring.NEG_INF, raw,
                          raw * rq.user_scale[ids][:, None] * rq.item_scale[None, :])
    q_items, _ = rq.recommend(batches[0], k=K)
    same_topk(q_items, plain_q, torch.topk(plain_q, K, dim=1).indices.cpu().numpy(),
              "int8 vs plain")
    log("[serve] checks passed: ids in range, no train positive, natural = plain, "
        "bit-plane = natural, npz round trip identical, int8 = plain")

    # ---- timing
    with torch.no_grad():
        prop_ms = cuda_ms(model.final_embeddings, reps=5, warmup=1)
    lat = []
    for i in range(30):
        t0 = time.perf_counter()
        retriever.recommend(batches[i % N_REQUESTS], k=K)
        lat.append(time.perf_counter() - t0)
    lat_p50_ms = 1e3 * float(np.median(lat[5:]))
    busy = profile_recommend(retriever, batches)

    d = ue.shape[1]
    u = ue[torch.as_tensor(batches[0], device=dev)].contiguous()
    rows = seen[torch.as_tensor(batches[0], device=dev)].contiguous()
    _, bp_items_t, bp_seen = bitplane._serve_tables
    bp_rows = bp_seen[torch.as_tensor(batches[0], device=dev)].contiguous()
    kernels = []
    for name, it, bits, flag, err_key in (
        ("masked_scores", ie, rows, False, "masked_scores"),
        ("masked_scores_bitplane", bp_items_t, bp_rows, True, "masked_scores_bitplane"),
    ):
        ms = cuda_ms(lambda: scoring.masked_scores(u, it, bits, bitplane=flag), reps=200, warmup=10)
        plain_ms = cuda_ms(lambda: masked_scores_reference(u, it, bits, bitplane=flag), reps=50)
        library_ms = cuda_ms(lambda: torch.matmul(u, it.T), reps=200, warmup=10)
        b_ms, b_by = bound(u.shape[0], d, it.shape[0], bits.shape[1])
        kernels.append(dict(
            name=name, route="cuda", source=KERNEL_SOURCE, replaces=REPLACES[name],
            launches=launches[name], max_abs_err=None, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
            shape=[int(u.shape[0]), int(d), int(it.shape[0])],
        ))
        log(f"[time] {name}: {ms * 1e3:.1f} us/launch, bound {b_ms * 1e3:.1f} us ({b_by}), "
            f"plain {plain_ms * 1e3:.1f} us, torch.matmul {library_ms * 1e3:.1f} us")
    log(f"[time] propagation (final_embeddings, 3 layers) {prop_ms:.3f} ms; "
        f"recommend p50 {lat_p50_ms:.3f} ms for {BATCH} users; peak device memory "
        f"{peak_mib:.1f} MiB")
    return dict(kernels=kernels, prop_ms=prop_ms, recommend_p50_ms=lat_p50_ms,
                peak_mib=peak_mib, recommend_device_busy=busy)


def profile_recommend(retriever, batches, rounds: int = 5) -> Optional[float]:
    """Device busy share of ``recommend`` (device time of all kernels and
    copies over the wall time of the window), with the kernels that take
    it. Only device-side events are summed: a CPU operator's device time
    is that of the kernels it launched, which are counted already."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    retriever.recommend(batches[0], k=K)  # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            for b in batches:
                retriever.recommend(b, k=K)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    calls = rounds * len(batches)
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = sum(t for _, t in rows)
    if not device_us:
        log("[profile] the profiler saw no device time: busy share not measured")
        return None
    log(f"[profile] recommend: {wall_us / calls:.1f} us wall, {device_us / calls:.1f} us "
        f"device per request of {BATCH} users (busy share {device_us / wall_us:.3f})")
    for key, t in sorted(rows, key=lambda r: -r[1])[:6]:
        log(f"[profile]   {t / calls:8.1f} us/request  {key[:90]}")
    return device_us / wall_us


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from gsrs_tpu_torch.device import resolve_device
    from gsrs_tpu_torch.kernels import build_kernels, library_path

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(card)

    t0 = time.perf_counter()
    build_logs = build_kernels(["masked_scores"])
    log(f"[build] {time.perf_counter() - t0:.1f} s -> {library_path('masked_scores')}")
    for name, text in build_logs.items():
        for line in text.strip().splitlines():
            log(f"[build] {name}: {line}")

    errs = kernel_phase(dev)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke")
    result = serving_phase(dev, GOWALLA_SHAPE, out_dir)
    for k in result["kernels"]:
        k["max_abs_err"] = errs[k["name"]]
    log(json.dumps({"card": card, "propagation_ms": result["prop_ms"],
                    "recommend_p50_ms": result["recommend_p50_ms"],
                    "recommend_device_busy": result["recommend_device_busy"],
                    "peak_device_mib": result["peak_mib"]}))
    log(json.dumps({"kernels": result["kernels"]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
