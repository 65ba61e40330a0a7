"""HSTU training traffic: the window calls `SeqTrainer.train_epoch` again
and again, each call ``max_steps_per_call`` steps (the trainer's public
``steps_per_call``; a call takes up the epoch's permutation where the
last one stopped), as `loops.seq_train`'s window does, on sequences
whose every slot carries its time. Parameters (``traffic/<mix>.json``):
``max_steps_per_call``, ``check_steps`` (the first steps of the first
call that the check follows), ``replay_steps`` (its last steps that the
check follows) and ``warmup_calls``.

Set-up builds the configuration's model through `build_seq_model`
("hstu") and one `SeqTrainer` on the sequences and their times (one eval
user, so that no catalog-wide eval bitset is built: the cell never
evaluates), puts the seeded weights into it and drives it through its
first call, recording on the way, through the trainer's per-step entry
(``_train_step``, which every step of a call goes through, eager,
captured or replayed): the batches, times and draws (the (B, N, K)
negatives and the dropout keep masks) of the first ``check_steps`` and
the last ``replay_steps`` steps, copied to the host; each step's loss;
the first gradient's leaf norms as Adam took it (its first moment after
one step, over 1 − β1); the leaf norms of the parameters' change after
step ``check_steps``; a host copy of the parameters and Adam's moments
just before the last ``replay_steps`` steps, and of the parameters after
them. On one card every step after the third is replayed from a CUDA
graph, so the last steps are replays, and the check sees what a replay
computes from the inputs copied into the graph (the times and the
negatives among them). The same trainer then serves the warm-up and the
window.

The check: the draws are valid (``draws_invalid``: a negative outside
[1, m] where the target is real, or not 0 where it is PAD), the window's
losses are finite, and the reference (`benchmark.reference.hstu`) gives
the same losses (``loss_gap``), first-gradient norms (``grad_gap``) and
change norms (``change_gap``) over the first steps from the seeded
weights, and the same losses (``replay_loss_gap``) and change norms
(``replay_change_gap``) over the last steps from the program's own
parameters and moments taken before them; gaps as `loops.seq_train`
measures them.

The window's ``work`` also carries ``real_slots`` (the loss's slots a
step: a real input and a real target) and ``causal_pairs`` (a step's
(query, key) pairs of real inputs with the key not after the query),
counted from the benchmark's own sequences, which `train_mfu.hstu` and
`head_real_share.hstu` read.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
from typing import Dict, List

import numpy as np
import torch

from benchmark import program, reference
from benchmark import sequences as bseq
from benchmark.loops import train as train_loop
from benchmark.loops.seq_train import _kept, _leaf_gap, seeded_weights
from benchmark.loops.train import BETA1, Sut, observe  # noqa: F401 (the loop's own)
from benchmark.timestamps import times_for

CHECKS = ("draws_invalid", "window_nonfinite", "loss_gap", "grad_gap", "change_gap",
          "replay_loss_gap", "replay_change_gap")
# the sequences of the CPU tests: the lengths' floor kept, the catalog cut
TINY_DATA = dict(n_users=40, m_items=300, n_actions=40 * 45, structure_seed=5)
# the CPU tests' cut: 2 blocks of the 8 and 50 slots of the 200, batches of
# 8 and calls of 7 steps (3 followed at each end); widths, heads,
# negatives and temperature kept (the last two are the program's constants)
TINY_MODEL = dict(num_blocks=2, max_len=50)
TINY_BATCH, TINY_STEPS = 8, 7
# At 400 slots a batch the first steps' gaps read up to 9.5e-6 (loss) and
# 1.3e-6 (grad) on the CPU over six seeds, above or near the limits set
# from readings at the cell's size; these stand in for them at the tiny
# size (the TF32 control reads 9.6e-5 and 8.5e-5 there at the least)
TINY_LIMITS = {"loss_gap": 5e-5, "grad_gap": 1e-5}


def tiny(cfg: dict, traffic: dict):
    """→ (cfg, traffic, limit overrides) at the size of the CPU tests (the
    cut above)."""
    cfg = copy.deepcopy(cfg)
    cfg["data"].update(TINY_DATA, max_len=TINY_MODEL["max_len"])
    cfg["model"].update(TINY_MODEL)
    cfg["train"]["batch_size"] = TINY_BATCH
    traffic = dict(traffic, max_steps_per_call=TINY_STEPS)
    return cfg, traffic, dict(TINY_LIMITS)


@dataclasses.dataclass
class Inputs:
    """The sequences and each slot's time."""

    seqs: bseq.Sequences
    times: np.ndarray  # (n_users, max_len) int64 seconds, 0 at PAD

    @property
    def m_items(self) -> int:
        return self.seqs.m_items


def make_inputs(cfg: dict, traffic: dict, seed: int, device):
    x = bseq.for_config(cfg, seed, device)
    return Inputs(x, times_for(x.train_seqs, cfg["data"]["times"], seed, device))


def slot_counts(train_seqs: np.ndarray, batch: int) -> Dict[str, float]:
    """The loss's slots and the causal pairs of real inputs a step, on
    average over the sequences: a sequence of n real ids has n − 1 real
    inputs, each with a real target, and (n − 1)·n / 2 such pairs."""
    r = np.maximum((train_seqs != 0).sum(axis=1) - 1, 0).astype(np.float64)
    return {"real_slots": batch * float(r.mean()),
            "causal_pairs": batch * float((r * (r + 1) / 2).mean())}


def sequence_data(name: str, x: Inputs):
    """The program's `SequenceData` of the benchmark's sequences and times;
    the eval, which the cell never runs, is one user with an empty
    history."""
    from gsrs_tpu_torch.data.sequences import SequenceData

    s = x.seqs
    return SequenceData(name=name, n_users=1, m_items=s.m_items, max_len=s.max_len,
                        train_seqs=s.train_seqs, eval_seqs=s.train_seqs[:1],
                        eval_users=np.zeros(1, np.int64), eval_targets=s.targets[:1],
                        user_hist_sets={}, train_times=x.times, eval_times=x.times[:1])


@dataclasses.dataclass
class HSTUSut(Sut):
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)


def _host(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: p.detach().to("cpu", copy=True) for k, p in params.items()}


def _capture_first_call(trainer, state, weights, n: int, last: int):
    """Run the trainer's first call, recording its first ``n`` and last
    ``last`` steps (the module's note)."""
    steps = trainer.steps_per_call
    if steps < n + last:
        raise ValueError(f"a call of {steps} steps: the check follows {n} and {last} steps")
    rec: Dict[str, object] = {"steps": [], "replay": [], "loss": []}
    train_step, count = trainer._train_step, [0]

    def record(st, seqs, draws, times):
        k = count[0]
        if k == steps - last:
            rec["before"] = _host(st.params)
            inner = st.opt_state.optimizer.state
            rec["moments"] = tuple({name: inner[p][key].to("cpu", copy=True)
                                    for name, p in st.params.items()}
                                   for key in ("exp_avg", "exp_avg_sq")) + (st.opt_state.count,)
        if k < n or k >= steps - last:
            rec["steps" if k < n else "replay"].append(dict(
                seqs=_kept(seqs), times=_kept(times), neg=_kept(draws.neg),
                keep=[_kept(m) for m in draws.model.keep]))
        new, loss = train_step(st, seqs, draws, times)
        rec["loss"].append(loss.detach())
        count[0] += 1
        if count[0] == 1:
            rec["grad"] = {k_: float(m.norm()) / (1 - BETA1)
                           for k_, m in program.first_moments(new.opt_state, new.params).items()}
        if count[0] == n:
            rec["change"] = {k_: float((p.detach() - weights[k_]).norm())
                             for k_, p in new.params.items()}
        return new, loss

    trainer._train_step = record
    try:
        state, _ = trainer.train_epoch(state)
    finally:
        del trainer._train_step
    rec["after"] = _host(state.params)
    rec["loss"] = torch.stack(rec["loss"]).tolist()
    return state, rec


def setup(cfg: dict, traffic: dict, inputs: Inputs, seed: int, device) -> HSTUSut:
    from gsrs_tpu_torch.models import hstu
    from gsrs_tpu_torch.models.registry import build_seq_model
    from gsrs_tpu_torch.train.seq_trainer import SeqTrainer

    m, t = cfg["model"], cfg["train"]
    if (m["num_negatives"], m["temperature"]) != (hstu.NEGATIVES, hstu.TEMPERATURE):
        raise ValueError(f"the configuration's {m['num_negatives']} negatives at temperature "
                         f"{m['temperature']} are not the program's {hstu.NEGATIVES} at "
                         f"{hstu.TEMPERATURE}")
    torch.backends.cuda.matmul.allow_tf32 = False  # float32, TF32 off: the configuration's
    torch.backends.cudnn.allow_tf32 = False
    phase = program.Phases(device)
    data = sequence_data(cfg["name"], inputs)
    phase("sequences")
    model = build_seq_model(
        m["model"], data.m_items, max_len=m["max_len"], dim=m["embedding_dim"],
        hidden=m["head_dim"], blocks=m["num_blocks"], heads=m["num_heads"],
        dropout=m["dropout_rate"], device=device)
    trainer = SeqTrainer(model, data, batch_size=t["batch_size"], lr=t["lr"], seed=seed % 2**63,
                         weight_decay=t["weight_decay"], adam_eps=t["adam_eps"],
                         adam_betas=tuple(t["adam_betas"]), device=device)
    trainer.steps_per_call = traffic["max_steps_per_call"]
    state = trainer.init_state()
    weights = seeded_weights(cfg, seed, device)
    if {k: tuple(p.shape) for k, p in state.params.items()} != \
            {k: tuple(w.shape) for k, w in weights.items()}:
        raise ValueError(f"the program's parameters {sorted(state.params)} are not the "
                         f"reference's {sorted(weights)}")
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(weights[k])
    phase("model and trainer")
    state, first = _capture_first_call(trainer, state, weights, traffic["check_steps"],
                                       traffic["replay_steps"])
    del weights
    phase("first call")
    for _ in range(traffic["warmup_calls"]):
        state, _ = trainer.train_epoch(state)
    phase("warm-up")
    return HSTUSut(trainer, state, t["batch_size"], trainer.steps_per_call, first,
                   counts=slot_counts(inputs.seqs.train_seqs, t["batch_size"]))


def window(sut: HSTUSut, seconds: float) -> dict:
    """`loops.train.window`, its ``work`` carrying the step's slot counts."""
    out = train_loop.window(sut, seconds)
    out["work"].update(sut.counts)
    return out


# ------------------------------------------------------------------ check


def invalid_draws(m_items: int, steps: List[dict]) -> int:
    """Negatives outside [1, m] at a real target, or not 0 at a PAD one."""
    bad = 0
    for s in steps:
        real = (s["seqs"] != 0)[..., None]
        neg = s["neg"]
        bad += int((real & ((neg < 1) | (neg > m_items))).sum())
        bad += int((~real & (neg != 0)).sum())
    return bad


def _gaps(got: dict, want: dict, prefix: str = "") -> dict:
    """The loss gap, the first gradient's (without ``prefix``) and the
    change's, named in `CHECKS`' order."""
    out = {f"{prefix}loss_gap": max(abs(a - b) for a, b in zip(got["loss"], want["loss"]))}
    if not prefix:
        out["grad_gap"] = _leaf_gap(got["grad"], want["grad"])
    out[f"{prefix}change_gap"] = _leaf_gap(got["change"], want["change"])
    return out


def _recorded(observed: dict, device):
    """The recorded first and replayed steps, and the program's state
    before the replays (parameters; moments and steps taken), on
    ``device``."""

    def to(s: dict) -> dict:
        return {k: [x.to(device) for x in v] if isinstance(v, list) else v.to(device)
                for k, v in s.items()}

    first, replay = [to(s) for s in observed["steps"]], [to(s) for s in observed["replay"]]
    before = {k: v.to(device) for k, v in observed["before"].items()}
    mom, vel, t0 = observed["moments"]
    moments = ({k: v.to(device) for k, v in mom.items()},
               {k: v.to(device) for k, v in vel.items()}, t0)
    return first, replay, before, moments


def check(cfg: dict, traffic: dict, inputs: Inputs, seed: int, observed: dict, device) -> dict:
    ref = reference.of(cfg)
    n = traffic["check_steps"]
    first, replay, before, moments = _recorded(observed, device)
    want = ref.train_replay(seeded_weights(cfg, seed, device), first, cfg)
    got = {"loss": observed["loss"][:n], "grad": observed["grad"], "change": observed["change"]}
    want_r = ref.train_replay(before, replay, cfg, moments=moments)
    # in float64: a float32 norm() on the CPU is off by about 2e-4 at the
    # item table's 6.8 M entries, which the check would read as a gap
    got_r = {"loss": observed["loss"][-len(replay):],
             "change": {k: float((observed["after"][k].double()
                                  - observed["before"][k].double()).norm())
                        for k in observed["before"]}}
    return dict(draws_invalid=invalid_draws(inputs.m_items, first + replay),
                window_nonfinite=observed["nonfinite"], **_gaps(got, want),
                **_gaps(got_r, want_r, "replay_"))


FAULTS = (("control", dict(tf32=True)), ("half_slots", dict(slot_share=0.5)),
          ("no_time", dict(no_time=True)), ("pad_keys", dict(pad_keys=True)),
          ("collisions", dict(keep_collisions=True)), ("stale_times", {}))


def control(cfg: dict, traffic: dict, inputs: Inputs, seed: int, device) -> Dict[str, dict]:
    """The readings of the reference put in the program's place, judged
    against the reference as the program is, at the points the check
    compares: the program's set-up is run and recorded as the cell's, and
    the reference follows its first ``check_steps`` steps from the seeded
    weights and its last ``replay_steps`` steps from the program's own
    parameters and moments before them, on the batches and draws the
    program took: with its products in TF32, the precision below the
    configuration's float32 (``control``); with the slots of half of each
    batch's sequences left out of the loss (``half_slots``); and with each
    planted fault: rab's time term dropped (``no_time``), PAD keys left in
    M (``pad_keys``), a negative equal to its target left in
    (``collisions``), and the replayed steps run on the times of the
    first step's batch, as a replay whose times were left stale in the
    graph's inputs computes (``stale_times``)."""
    ref = reference.of(cfg)
    sut = setup(cfg, traffic, inputs, seed, device)
    observed = sut.first
    del sut
    gc.collect()
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
    first, replay, before, moments = _recorded(observed, device)
    weights = seeded_weights(cfg, seed, device)
    want = ref.train_replay(weights, first, cfg)
    want_r = ref.train_replay(before, replay, cfg, moments=moments)
    out = {}
    for name, fault in FAULTS:
        got = ref.train_replay(weights, first, cfg, **fault)
        run = replay
        if name == "stale_times":
            run = [dict(s, times=first[0]["times"]) for s in replay]
        got_r = ref.train_replay(before, run, cfg, moments=moments, **fault)
        out[name] = dict(_gaps(got, want), **_gaps(got_r, want_r, "replay_"))
    return out
