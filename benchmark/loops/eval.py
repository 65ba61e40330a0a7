"""Full-catalog evaluation traffic: the window calls `Trainer.evaluate`
again and again on seeded tables. Each call is one propagation, then
every test user in batches of ``test_batch``: the masked scores, the
exact top-k and the metrics. Parameters (``traffic/<mix>.json``):
``warmup_calls`` and ``overrides`` (sections merged into the
configuration's, such as another ``eval.topk_method``).

Each call's top-k ids are kept as the evaluator hands them to its
metrics (a hook on its ``_top_items``, which holds the ids of the call's
batches and copies nothing). The check: the reference scores every test
user against the whole catalog with the train pairs masked, and every id
the last call ranked j-th must score within the limit of the reference's
j-th best. The metrics are not compared: on seeded tables they sit at
chance, a few hits in a whole eval or none, where neither a lower
precision nor a fault shows in them; the ids of every test user do.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import data as bdata
from benchmark import program, reference

BLOCK = 2048  # users the reference scores at once
# the names `check` returns, each with a limit in ``limits/<workload>.json``
CHECKS = ("rank_gap",)


def tiny(cfg: dict, traffic: dict):
    """→ (cfg, traffic, limit overrides) at the size of the CPU tests."""
    from benchmark.loops.train import tiny_graph

    return tiny_graph(cfg), dict(traffic), {}


def make_inputs(cfg: dict, traffic: dict, seed: int, device):
    return bdata.for_config(cfg, seed, device)


@dataclasses.dataclass
class Sut:
    trainer: object
    state: object
    n_test_users: int
    words: int
    k: int
    tops: List[torch.Tensor] = dataclasses.field(default_factory=list)
    metrics: List[Dict[str, float]] = dataclasses.field(default_factory=list)


def setup(cfg: dict, traffic: dict, inputs, seed: int, device) -> Sut:
    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.train.trainer import Trainer

    phase = program.Phases(device)
    ecfg = program.experiment_config(cfg, seed)
    data = program.interaction_data(cfg["name"], inputs)
    graph = build_graph(data)
    model = build_model(ecfg.model, graph, device=device)
    phase("graph and model")
    trainer = Trainer(ecfg, data, graph, model, run_eval=True, device=device)
    phase("trainer and evaluator")
    state = trainer.init_state()
    program.set_tables(model, bdata.tables(seed, inputs.n_users + inputs.m_items,
                                           ecfg.model.embedding_dim, device))
    ev = trainer.evaluator
    sut = Sut(trainer, state, ev.n_test_users, -(-inputs.m_items // 32), ev.max_k)
    ranked = ev._top_items

    def kept(u_emb, items, rows):
        top, valid = ranked(u_emb, items, rows)
        sut.tops.append(top)
        return top, valid

    ev._top_items = kept
    for _ in range(traffic["warmup_calls"]):
        trainer.evaluate(state)
    phase("warm-up")
    return sut


def window(sut: Sut, seconds: float) -> dict:
    """Calls until ``seconds`` have passed; each returns its metrics on
    the host, so the window ends synchronized."""
    calls, ends = 0, []
    t0 = time.perf_counter()
    while True:
        sut.tops.clear()
        sut.metrics.append(sut.trainer.evaluate(sut.state))
        calls += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    elapsed = ends[-1]
    return dict(metrics={"eval_users_per_s": calls * sut.n_test_users / elapsed},
                work={"units": calls, "evals": calls, "seconds": elapsed,
                      "n_test_users": sut.n_test_users, "words": sut.words,
                      "k": sut.k, "call_s": list(np.diff([0.0] + ends))},
                attempted=calls,
                failed=sum(not all(np.isfinite(list(m.values()))) for m in sut.metrics[-calls:]))


def observe(sut: Sut) -> dict:
    tops = torch.cat(sut.tops)[: sut.n_test_users].cpu()
    out = dict(tops=tops, n_test_users=sut.n_test_users, k=sut.k)
    sut.trainer = sut.state = None
    sut.tops.clear()
    return out


def _judge(cfg, inputs, seed, device, k, ids_of=None, control=False) -> float:
    """Walk the test users in blocks → the widest rank gap of the judged
    ids: ``ids_of``'s, or with ``control`` the reference's own top-k of
    TF32-rounded scores."""
    ref = reference.of(cfg)
    n, m = inputs.n_users, inputs.m_items
    adj = ref.norm_adjacency(inputs.train_users, inputs.train_items, n, m, device)
    tables = bdata.tables(seed, n + m, cfg["model"]["embedding_dim"], device)
    U, I = ref.final_tables(adj, tables, n, cfg["model"]["num_layers"])
    del adj, tables
    train = ref.csr(inputs.train_users, inputs.train_items, n)
    users = np.unique(inputs.test_users)
    gap = 0.0
    for s in range(0, users.size, BLOCK):
        b = users[s:s + BLOCK]
        rows = U[torch.as_tensor(b, device=device)]
        exact = ref.scores(rows, I, b, train)
        ids = (ref.scores(rows, I, b, train, tf32=True).topk(k, dim=1).indices if control
               else ids_of(s, b.size).to(device))
        gap = max(gap, float(ref.rank_gap(exact, ids).max()))
        del exact
    return gap


def check(cfg: dict, traffic: dict, inputs, seed: int, observed: dict, device) -> dict:
    """The rank gap of the last call's ids; users missing from the
    program's answer read as an infinite rank gap."""
    tops, k = observed["tops"], observed["k"]

    def ids_of(s, b):
        if s + b <= tops.shape[0]:
            return tops[s:s + b]
        return torch.full((b, k), -1, dtype=torch.int64)

    return dict(rank_gap=_judge(cfg, inputs, seed, device, k, ids_of))


def control(cfg: dict, traffic: dict, inputs, seed: int, device) -> Dict[str, dict]:
    """The reference in the program's place one precision below the
    configuration's: its scores of TF32-rounded inputs (the configuration
    scores in float32 with TF32 off); judged as the program is."""
    gap = _judge(cfg, inputs, seed, device, max(cfg["eval"]["topks"]), control=True)
    return {"control": dict(rank_gap=gap)}
