"""Request traffic in a closed loop: one caller, no think time, each
request a `Retriever.recommend([user], k)` call for one user, timed from
the call until its ids are on the host.

The requests are LightGCN's test protocol, one user a call: every user
with a test pair, each once, in an order drawn from the seed; the window
goes round again if it gets through them. Every seed so sends the same
requests, in its own order. Parameters (``traffic/<mix>.json``): ``k``;
``retriever_batch``; ``use_pallas_scoring``; ``warmup_requests``, drawn
from another order; ``check_requests``, the requests the check samples
from the seed.

The Retriever is built as `gsrs_tpu_torch.serve.load_retriever` builds
it: post-propagation float32 tables (made from the seed) and the train
bitset of the generated pairs. No propagation runs.

The check: the reference scores each sampled request's user against the
catalog with its train pairs masked; every id ranked j-th must score
within the limit of the reference's j-th best, every score must be the
reference's score of its id, and a −1 slot may stand only where the user
has fewer unseen items than k.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch

from benchmark import data as bdata
from benchmark import reference

BLOCK = 2048  # users the reference scores at once
# the names `check` returns, each with a limit in ``limits/<workload>.json``
CHECKS = ("rank_gap", "score_gap")


def tiny(cfg: dict, traffic: dict):
    """→ (cfg, traffic, limit overrides) at the size of the CPU tests:
    5 warm-up requests, and 20 that the check samples."""
    from benchmark.loops.train import tiny_graph

    return tiny_graph(cfg), dict(traffic, warmup_requests=5, check_requests=20), {}


def requests(x: bdata.Interactions, seed: int, which: int) -> List[np.ndarray]:
    """Every user with a test pair, one a request, in the order of stream
    ``which`` of the seed."""
    users = np.unique(x.test_users)
    return [users[j:j + 1] for j in bdata.stream(seed, which).permutation(users.size)]


@dataclasses.dataclass
class Inputs:
    data: bdata.Interactions
    plan: List[np.ndarray]
    warmup: List[np.ndarray]


def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> Inputs:
    x = bdata.for_config(cfg, seed, device)
    return Inputs(x, requests(x, seed, bdata.REQUESTS),
                  requests(x, seed, bdata.WARMUP)[: traffic["warmup_requests"]])


@dataclasses.dataclass
class Sut:
    retriever: object
    plan: List[np.ndarray]
    k: int
    sent: int = 0  # requests sent so far: the next is plan[sent % len(plan)]
    answers: list = dataclasses.field(default_factory=list)
    latency: List[float] = dataclasses.field(default_factory=list)


def setup(cfg: dict, traffic: dict, inputs: Inputs, seed: int, device) -> Sut:
    from gsrs_tpu_torch.ops.bitset import build_bitset
    from gsrs_tpu_torch.serve import Retriever

    x = inputs.data
    tables = bdata.tables(seed, x.n_users + x.m_items, cfg["model"]["embedding_dim"], device)
    seen = build_bitset(x.train_users, x.train_items, x.n_users, x.m_items)
    retriever = Retriever(tables[:x.n_users], tables[x.n_users:], seen,
                          batch_size=traffic["retriever_batch"],
                          use_pallas_scoring=traffic["use_pallas_scoring"], device=device)
    k = traffic["k"]
    for users in inputs.warmup:
        retriever.recommend(users, k=k)
    return Sut(retriever, inputs.plan, k)


def window(sut: Sut, seconds: float) -> dict:
    """Requests in turn until ``seconds`` have passed (the plan goes round
    again if it runs out)."""
    rec = sut.retriever.recommend
    k = sut.k
    t0 = time.perf_counter()
    i = 0
    while True:
        users = sut.plan[(sut.sent + i) % len(sut.plan)]
        s = time.perf_counter()
        items, scores = rec(users, k=k)
        e = time.perf_counter()
        sut.latency.append(e - s)
        sut.answers.append((users, items, scores))
        i += 1
        if e - t0 >= seconds:
            break
    sut.sent += i
    lat = np.asarray(sut.latency[-i:])
    return dict(metrics={"request_p95_ms": float(np.percentile(lat, 95)) * 1e3},
                work={"units": i, "requests": i, "seconds": e - t0, "k": k,
                      "call_s": list(lat)},
                attempted=i, failed=0)


def observe(sut: Sut) -> dict:
    out = dict(answers=sut.answers, k=sut.k)
    sut.retriever = None
    return out


def _judge(cfg, x, seed, device, users, k, items=None, scores=None, tf32_control=False):
    """→ (rank gap, score gap) over the given users; a −1 slot where the
    user has k unseen items or more reads as an infinite rank gap."""
    ref = reference.of(cfg)
    n, m = x.n_users, x.m_items
    tables = bdata.tables(seed, n + m, cfg["model"]["embedding_dim"], device)
    U, I = tables[:n], tables[n:]
    train = ref.csr(x.train_users, x.train_items, n)
    rank_gap = score_gap = 0.0
    for s in range(0, users.size, BLOCK):
        b = users[s:s + BLOCK]
        exact = ref.scores(U[torch.as_tensor(b, device=device)], I, b, train)
        if tf32_control:
            got_s, got = ref.scores(U[torch.as_tensor(b, device=device)], I, b, train,
                                    tf32=True).topk(k, dim=1)
        else:
            got = torch.as_tensor(items[s:s + BLOCK], device=device).long()
            got_s = torch.as_tensor(scores[s:s + BLOCK], device=device)
        unseen = torch.isfinite(exact).sum(1, keepdim=True)
        slot = torch.arange(k, device=device)[None, :]
        empty = got < 0
        best = exact.topk(k, dim=1).values
        at = exact.gather(1, got.clamp(0, m - 1))
        at = torch.where(got >= m, torch.full_like(at, float("-inf")), at)
        zero, inf = torch.zeros_like(at), torch.full_like(at, float("inf"))
        # a -1 slot is right only where the user has fewer unseen items than k
        rank = torch.where(empty, torch.where(slot < unseen, inf, zero), best - at)
        err = torch.where(empty, zero, (got_s - at).abs())
        rank_gap = max(rank_gap, float(torch.nan_to_num(rank, nan=float("inf")).max()))
        score_gap = max(score_gap, float(torch.nan_to_num(err, nan=float("inf")).max()))
    return rank_gap, score_gap


def _sample(answers, traffic, seed):
    rng = bdata.stream(seed, bdata.SAMPLE)
    n = len(answers)
    return sorted(rng.choice(n, size=min(traffic["check_requests"], n), replace=False).tolist())


def check(cfg: dict, traffic: dict, inputs: Inputs, seed: int, observed: dict, device) -> dict:
    answers, k = observed["answers"], observed["k"]
    picked = [answers[i] for i in _sample(answers, traffic, seed)]
    users = np.concatenate([a[0] for a in picked])
    items = np.concatenate([a[1] for a in picked])
    scores = np.concatenate([a[2] for a in picked])
    rank_gap, score_gap = _judge(cfg, inputs.data, seed, device, users, k, items, scores)
    return dict(rank_gap=rank_gap, score_gap=score_gap)


def control(cfg: dict, traffic: dict, inputs: Inputs, seed: int, device) -> dict:
    """The reference scoring in TF32 (the configuration scores in float32
    with TF32 off) over the users of as many requests as a run checks."""
    plan = inputs.plan[: traffic["check_requests"]]
    users = np.concatenate(plan)
    rank_gap, score_gap = _judge(cfg, inputs.data, seed, device, users, traffic["k"],
                                 tf32_control=True)
    return {"control": dict(rank_gap=rank_gap, score_gap=score_gap)}
