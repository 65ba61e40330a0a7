"""Training traffic: the window calls `Trainer.train_epoch` again and
again. Parameters (``traffic/<mix>.json``): ``max_steps_per_call``, the
steps of one call at most (the Trainer's public ``epoch_samples`` is set
to that many batches when an epoch is longer), ``check_steps``, the
steps the reference follows, and ``warmup_calls``.

Set-up builds one Trainer (graph, layout, model, sampler, optimizer),
puts the seeded tables into it, and drives it through its first call,
recording on the way what the check needs: the sampled triplets of the
first steps as the window's own feed drew them, those steps' losses, the
first gradient's leaf norms as Adam took it (its first moment after one
step, over 1 − β1) and the leaf norms of the parameters' change after
the last of them. The same Trainer then serves the warm-up and the
window.

The check: the triplets are valid (each positive a train pair of its
user, each negative not), and the reference, from the same tables on the
same triplets, gives the same losses and norms.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import data as bdata
from benchmark import program, reference

BETA1 = 0.9
LOWER = {"float32": torch.bfloat16, "bfloat16": torch.float8_e4m3fn}
# the names `check` returns, each with a limit in ``limits/<workload>.json``
CHECKS = ("sampler_invalid", "window_nonfinite", "loss_gap", "grad_gap", "change_gap")

# The interactions of the graph loops' CPU tests
TINY_DATA = dict(n_users=300, m_items=500, n_train=6000, n_test=1500, zipf_s=1.1,
                 structure_seed=5)
# bf16 rounding over the tiny graph and a 2,000-row batch reads up to 1.9e-6,
# 4.5e-4 and 1.3e-4 on the CPU (five seeds), above the limits set from
# readings at the cell's size; these stand in for them at the tiny size
TINY_BF16_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-3, "change_gap": 1e-3}


def tiny_graph(cfg: dict) -> dict:
    """``cfg`` at the size of the CPU tests, its settings kept: the tiny
    interactions, a 2,000-row batch, test batches of 64 and, for the
    tiled layout, G 4 x C 64."""
    cfg = copy.deepcopy(cfg)
    cfg["data"] = dict(TINY_DATA)
    cfg["train"]["batch_size"] = 2000
    cfg["eval"]["test_batch"] = 64
    if cfg["model"].get("spmm_mode") == "tiled":
        cfg["model"].update(tiled_groups=4, tiled_cols=64)
    return cfg


def tiny(cfg: dict, traffic: dict):
    """→ (cfg, traffic, limit overrides) at the size of the CPU tests;
    bf16 training is held to the tiny size's limits."""
    bf16 = cfg["precision"]["propagation"] == "bfloat16"
    return tiny_graph(cfg), dict(traffic), dict(TINY_BF16_LIMITS if bf16 else {})


def make_inputs(cfg: dict, traffic: dict, seed: int, device):
    return bdata.for_config(cfg, seed, device)


@dataclasses.dataclass
class Sut:
    trainer: object
    state: object
    batch: int
    steps_per_call: int
    first: dict
    window_losses: List[float] = dataclasses.field(default_factory=list)


def _capture_first_steps(trainer, state, tables, n: int):
    """Run the Trainer's first call, recording the first ``n`` steps."""
    rec: Dict[str, object] = {}
    n_users = trainer.model.user_emb.shape[0]
    start = {"user_emb": tables[:n_users], "item_emb": tables[n_users:]}
    opt = trainer.optimizer
    run_steps, opt_step, count = trainer.run_steps, opt.step, [0]

    def step(params, opt_state):
        new = opt_step(params, opt_state)
        count[0] += 1
        if count[0] == 1:
            rec["grad"] = {k: float(m.norm()) / (1 - BETA1)
                           for k, m in program.first_moments(new, params).items()}
        if count[0] == n:
            rec["change"] = {k: float((p.detach() - start[k]).norm()) for k, p in params.items()}
        return new

    def record(state_, users_b, pos_b, neg_b, gen=None):
        if "batches" not in rec:
            if users_b.shape[0] < n:
                raise ValueError(f"the first chunk has {users_b.shape[0]} steps, the check "
                                 f"follows {n}")
            rec["batches"] = [(users_b[j].clone(), pos_b[j].clone(), neg_b[j].clone())
                              for j in range(n)]
        new_state, losses = run_steps(state_, users_b, pos_b, neg_b, gen)
        if "loss" not in rec:
            rec["loss"] = [float(x) for x in losses[:n]]
        return new_state, losses

    trainer.run_steps, opt.step = record, step
    try:
        state, _ = trainer.train_epoch(state)
    finally:
        del trainer.run_steps, opt.step
    return state, rec


def setup(cfg: dict, traffic: dict, inputs, seed: int, device) -> Sut:
    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.ops.tiled import tiled_from_interactions
    from gsrs_tpu_torch.train.trainer import Trainer

    phase = program.Phases(device)
    ecfg = program.experiment_config(cfg, seed)
    data = program.interaction_data(cfg["name"], inputs)
    graph = build_graph(data)
    phase("graph")
    m = ecfg.model
    layout = None
    if m.spmm_mode == "tiled":  # as gsrs_tpu_torch.bench.run_bench builds it
        layout = tiled_from_interactions(
            data, groups=m.tiled_groups, cols=m.tiled_cols,
            dtype=torch.bfloat16 if m.bf16_compute else torch.float32)
    phase("layout")
    model = build_model(m, graph, ell=layout, device=device)
    trainer = Trainer(ecfg, data, graph, model, run_eval=False, device=device)
    phase("model and trainer")
    B = ecfg.train.batch_size
    steps = min(-(-data.train_size // B), traffic["max_steps_per_call"])
    if steps < -(-data.train_size // B):
        trainer.epoch_samples = steps * B
    state = trainer.init_state()
    tables = bdata.tables(seed, inputs.n_users + inputs.m_items, m.embedding_dim, device)
    program.set_tables(model, tables)
    state, first = _capture_first_steps(trainer, state, tables, traffic["check_steps"])
    del tables
    phase("first call")
    for _ in range(traffic["warmup_calls"]):
        state, _ = trainer.train_epoch(state)
    phase("warm-up")
    return Sut(trainer, state, B, steps, first)


def window(sut: Sut, seconds: float) -> dict:
    """Calls until ``seconds`` have passed; each call ends reading its mean
    loss, so the window ends synchronized."""
    calls, ends = 0, []
    t0 = time.perf_counter()
    while True:
        sut.state, loss = sut.trainer.train_epoch(sut.state)
        sut.window_losses.append(loss)
        calls += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    elapsed = ends[-1]
    steps = calls * sut.steps_per_call
    return dict(metrics={"train_samples_per_s": steps * sut.batch / elapsed},
                work={"units": steps, "steps": steps, "seconds": elapsed,
                      "call_s": list(np.diff([0.0] + ends))},
                attempted=calls,
                failed=sum(not math.isfinite(x) for x in sut.window_losses[-calls:]))


def observe(sut: Sut) -> dict:
    """What the check judges; the program's state is dropped."""
    first = sut.first
    out = dict(first, nonfinite=sum(not math.isfinite(x) for x in sut.window_losses))
    sut.trainer = sut.state = sut.first = None
    return out


# ------------------------------------------------------------------ check


def _pair_keys(inputs, m: int, device) -> torch.Tensor:
    keys = inputs.train_users.astype(np.int64) * m + inputs.train_items
    return torch.as_tensor(np.sort(keys), device=device)


def _is_pair(keys: torch.Tensor, users, items, m: int) -> torch.Tensor:
    k = users * m + items
    at = torch.searchsorted(keys, k).clamp(max=keys.numel() - 1)
    return keys[at] == k


def invalid_triplets(inputs, batches, device) -> int:
    """Triplets whose positive is not a train pair of their user, or whose
    negative is one, or whose ids lie outside the catalog."""
    n, m = inputs.n_users, inputs.m_items
    keys = _pair_keys(inputs, m, device)
    bad = 0
    for users, pos, neg in batches:
        in_range = ((users >= 0) & (users < n) & (pos >= 0) & (pos < m)
                    & (neg >= 0) & (neg < m))
        u, p, q = users.clamp(0, n - 1), pos.clamp(0, m - 1), neg.clamp(0, m - 1)
        ok = in_range & _is_pair(keys, u, p, m) & ~_is_pair(keys, u, q, m)
        bad += int((~ok).sum())
    return bad


def _leaf_gap(got: Dict[str, float], want: List[float]) -> float:
    """The worst leaf's gap between two norms, against the larger of the
    reference's leaf norm and its median leaf norm."""
    names = ("user_emb", "item_emb")
    med = statistics.median(want)
    return max(abs(got[k] - w) / max(w, med) for k, w in zip(names, want))


def _gaps(got: dict, want: dict) -> dict:
    return {"loss_gap": max(abs(a - b) for a, b in zip(got["loss"], want["loss"])),
            "grad_gap": _leaf_gap(got["grad"], want["grad"]),
            "change_gap": _leaf_gap(got["change"], want["change"])}


def _replay(cfg, inputs, seed, batches, device, **kw):
    ref = reference.of(cfg)
    n, m = inputs.n_users, inputs.m_items
    adj = ref.norm_adjacency(inputs.train_users, inputs.train_items, n, m, device)
    tables = bdata.tables(seed, n + m, cfg["model"]["embedding_dim"], device)
    t = cfg["train"]
    return ref.train_replay(adj, tables, n, cfg["model"]["num_layers"], batches, t["lr"],
                            t["decay"], **kw)


def check(cfg: dict, traffic: dict, inputs, seed: int, observed: dict, device) -> dict:
    batches = [tuple(x.to(device) for x in b) for b in observed["batches"]]
    want = _replay(cfg, inputs, seed, batches, device)
    got = {k: observed[k] for k in ("loss", "grad", "change")}
    return dict(sampler_invalid=invalid_triplets(inputs, batches, device),
                window_nonfinite=observed["nonfinite"], **_gaps(got, want))


def reference_batches(cfg: dict, inputs, seed: int, steps: int, batch: int, device):
    """Uniform BPR triplets drawn by plain code from the seed: users
    uniform over users with a train pair, positives uniform over theirs,
    negatives uniform over the rest of the catalog."""
    ref = reference.of(cfg)
    g = torch.Generator(device).manual_seed(bdata.torch_seed(seed, bdata.SAMPLE))
    indptr, items = ref.csr(inputs.train_users, inputs.train_items, inputs.n_users)
    indptr_t, items_t = (torch.as_tensor(a, device=device) for a in (indptr, items))
    valid = torch.as_tensor(np.flatnonzero(np.diff(indptr) > 0), device=device)
    keys = _pair_keys(inputs, inputs.m_items, device)
    out = []
    for _ in range(steps):
        u = valid[torch.randint(0, valid.numel(), (batch,), generator=g, device=device)]
        deg = indptr_t[u + 1] - indptr_t[u]
        off = torch.randint(0, 2**31 - 1, (batch,), generator=g, device=device) % deg
        p = items_t[indptr_t[u] + off]
        q = torch.randint(0, inputs.m_items, (batch,), generator=g, device=device)
        for _ in range(64):
            clash = _is_pair(keys, u, q, inputs.m_items)
            if not bool(clash.any()):
                break
            q = torch.where(clash, torch.randint(0, inputs.m_items, (batch,), generator=g,
                                                 device=device), q)
        out.append((u, p, q))
    return out


def control(cfg: dict, traffic: dict, inputs, seed: int, device) -> Dict[str, dict]:
    """The readings of the reference put in the program's place: in the
    precision below the configuration's (``control``), and with half of
    each batch left out and the mean taken over the rest (``half_batch``);
    each judged against the reference as the program is."""
    batches = reference_batches(cfg, inputs, seed, traffic["check_steps"],
                                cfg["train"]["batch_size"], device)
    want = _replay(cfg, inputs, seed, batches, device)
    out = {}
    lower = LOWER[cfg["precision"]["propagation"]]
    for name, kw in (("control", dict(dtype=lower)), ("half_batch", dict(batch_share=0.5))):
        got = _replay(cfg, inputs, seed, batches, device, **kw)
        got["grad"] = dict(zip(("user_emb", "item_emb"), got["grad"]))
        got["change"] = dict(zip(("user_emb", "item_emb"), got["change"]))
        out[name] = _gaps(got, want)
    return out
