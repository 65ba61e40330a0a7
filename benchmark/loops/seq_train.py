"""Sequential training traffic: the window calls `SeqTrainer.train_epoch`
again and again, each call ``max_steps_per_call`` steps (the trainer's
public ``steps_per_call``; a call takes up the epoch's permutation where
the last one stopped, and goes on into the next epoch's). Parameters
(``traffic/<mix>.json``): ``max_steps_per_call``, ``check_steps``, the
first steps whose losses and change the check compares, and
``warmup_calls``.

Set-up builds the configuration's model through `build_seq_model` and
one `SeqTrainer` (its sequences, one eval user with an empty history, so
that no catalog-wide eval bitset is built: the cell never evaluates; the
optimizer), puts the seeded weights into it and drives it through its
first call, recording on the way what the check needs: the batches and
the draws of every step of that call as the window's own trainer drew
them (the slots' positions and weights, the corrupted sequences, the
dropout keep masks; copied to the host, so that they hold none of the
card's memory), each step's loss, the first gradient's leaf norms as
Adam took it (its first moment after one step, over 1 − β1: the clipped
gradient), the leaf norms of the parameters' change after step
``check_steps`` and the parameters' leaf norms after the call. The same
trainer then serves the warm-up and the window.

The check: the draws keep to the published cloze (``draws_invalid``: a
weighted slot on PAD or twice on one position, a sequence whose slot
count is neither min(P, n, max(1, round(ρ·n))) nor a last-item-only
sample's one slot on its last item, a corrupted token that is not the
sequence's where no slot is, or not MASK where one is), and the reference
(`benchmark.reference.bert4rec`), from the same weights on the same
batches and draws, gives the same losses over the first ``check_steps``
(``loss_gap``), gradient norms (``grad_gap``), change norms
(``change_gap``), and parameter norms after the whole call
(``norm_gap``). The last is what sees the decoupled weight decay: BERT's
warm-up gives the first steps learning rates of 0, 1e-6 and 2e-6, at
which the decay moves each weight by about 1e-10, far below anything the
first steps' gaps can tell; over the call's 128 steps it shrinks every
matrix's norm by about 8e-5 of itself (PERF.md §4).
"""

from __future__ import annotations

import copy
import statistics
from typing import Dict, List

import numpy as np
import torch

from benchmark import data as bdata
from benchmark import program, reference
from benchmark import sequences as bseq
from benchmark.loops.train import BETA1, Sut, observe, window  # noqa: F401 (the loop's own)

CHECKS = ("draws_invalid", "window_nonfinite", "loss_gap", "grad_gap", "change_gap",
          "norm_gap")
# the sequences of the CPU tests: the lengths' floor kept, the catalog cut
TINY_DATA = dict(n_users=40, m_items=300, n_actions=40 * 45, structure_seed=5)
TINY_BATCH, TINY_STEPS = 16, 4


def tiny(cfg: dict, traffic: dict):
    """→ (cfg, traffic, limit overrides) at the size of the CPU tests: the
    tiny sequences (``max_len`` and every width kept), batches of 16 and
    calls of 4 steps."""
    cfg = copy.deepcopy(cfg)
    cfg["data"].update(TINY_DATA)
    cfg["train"]["batch_size"] = TINY_BATCH
    traffic = dict(traffic, max_steps_per_call=TINY_STEPS,
                   check_steps=min(traffic["check_steps"], TINY_STEPS))
    return cfg, traffic, {}


def make_inputs(cfg: dict, traffic: dict, seed: int, device):
    return bseq.for_config(cfg, seed, device)


def sequence_data(name: str, x: bseq.Sequences):
    """The program's `SequenceData` of the benchmark's sequences: every
    user trains on its sequence; the eval, which the cell never runs, is
    one user with an empty history, so the trainer builds no catalog-wide
    bitset."""
    from gsrs_tpu_torch.data.sequences import SequenceData

    return SequenceData(name=name, n_users=1, m_items=x.m_items, max_len=x.max_len,
                        train_seqs=x.train_seqs, eval_seqs=x.train_seqs[:1],
                        eval_users=np.zeros(1, np.int64), eval_targets=x.targets[:1],
                        user_hist_sets={})


def seeded_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter drawn from the seed on ``device``, in the
    reference's order: N(0, init_std²), LayerNorm scales 1 + N(0,
    init_std²)."""
    ref = reference.of(cfg)
    g = torch.Generator(device).manual_seed(bdata.torch_seed(seed, bdata.WEIGHTS))
    std = cfg["train"]["init_std"]
    out = {}
    for name, shape in ref.param_shapes(cfg).items():
        x = torch.randn(shape, generator=g, device=device, dtype=torch.float32) * std
        out[name] = x + 1.0 if name.endswith("_scale") else x
    return out


def _kept(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` for the check: on the host, copied behind the step's
    work (the call's draws would hold GBs of the card's memory)."""
    return x.to("cpu", non_blocking=True) if x.is_cuda else x.clone()


def _capture_first_call(trainer, state, weights, n: int):
    """Run the trainer's first call, recording every step of it (the
    module's note); ``n``: the steps after which the change is taken."""
    rec: Dict[str, object] = {"steps": [], "loss": []}
    model, opt = trainer.model, trainer.optimizer
    draw_step, opt_step, model_loss, count = (trainer.draw_step, opt.step,
                                              model.next_item_bpr_loss, [0])

    def draw(seqs, generator):
        d = draw_step(seqs, generator)
        c = d.model
        rec["steps"].append(dict(
            seqs=_kept(seqs), corrupted=_kept(c.corrupted), positions=_kept(c.positions),
            weights=_kept(c.weights), keep=None if c.keep is None else [_kept(k) for k in c.keep]))
        return d

    def loss(*args, **kw):
        out = model_loss(*args, **kw)
        rec["loss"].append(out[0].detach())
        return out

    def step(params, opt_state):
        new = opt_step(params, opt_state)
        count[0] += 1
        if count[0] == 1:
            rec["grad"] = {k: float(m.norm()) / (1 - BETA1)
                           for k, m in program.first_moments(new, params).items()}
        if count[0] == n:
            rec["change"] = {k: float((p.detach() - weights[k]).norm())
                             for k, p in params.items()}
        return new

    trainer.draw_step, opt.step, model.next_item_bpr_loss = draw, step, loss
    try:
        state, _ = trainer.train_epoch(state)
    finally:
        del trainer.draw_step, opt.step, model.next_item_bpr_loss
    if len(rec["steps"]) < n:
        raise ValueError(f"the first call ran {len(rec['steps'])} steps, the check follows {n}")
    rec["loss"] = torch.stack(rec["loss"]).tolist()
    rec["norm"] = {k: float(p.detach().double().norm()) for k, p in state.params.items()}
    return state, rec


def setup(cfg: dict, traffic: dict, inputs, seed: int, device) -> Sut:
    from gsrs_tpu_torch.models.registry import build_seq_model
    from gsrs_tpu_torch.train.seq_trainer import SeqTrainer

    torch.backends.cuda.matmul.allow_tf32 = False  # float32, TF32 off: the configuration's
    torch.backends.cudnn.allow_tf32 = False
    phase = program.Phases(device)
    data = sequence_data(cfg["name"], inputs)
    phase("sequences")
    m, t = cfg["model"], cfg["train"]
    model = build_seq_model(
        m["model"], data.m_items, max_len=m["max_len"], dim=m["embedding_dim"],
        hidden=m["ffn_hidden"], blocks=m["num_blocks"], heads=m["num_heads"],
        dropout=m["dropout_rate"], mask_prob=m["mask_prob"], last_only_prob=m["last_only_prob"],
        published=m["max_predictions"], device=device)
    trainer = SeqTrainer(model, data, batch_size=t["batch_size"], lr=t["lr"], seed=seed % 2**63,
                         warmup_steps=t["warmup_steps"], decay_steps=t["decay_steps"],
                         weight_decay=t["weight_decay"], clip_norm=t["clip_norm"],
                         adam_eps=t["adam_eps"], device=device)
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
    state, first = _capture_first_call(trainer, state, weights, traffic["check_steps"])
    del weights
    phase("first call")
    for _ in range(traffic["warmup_calls"]):
        state, _ = trainer.train_epoch(state)
    phase("warm-up")
    return Sut(trainer, state, t["batch_size"], trainer.steps_per_call, first)


# ------------------------------------------------------------------ check


def slot_rule(n: np.ndarray, cfg: dict) -> np.ndarray:
    """The published slot count of sequences of ``n`` real items."""
    m = cfg["model"]
    want = np.clip(np.round(n * m["mask_prob"]), 1, m["max_predictions"]).astype(np.int64)
    return np.minimum(want, n)


def invalid_draws(cfg: dict, steps: List[dict]) -> int:
    """The faults of the recorded draws against the published cloze (the
    module's note), counted."""
    mask = cfg["data"]["m_items"] + 1
    bad = 0
    for s in steps:
        seqs, corrupted = s["seqs"].cpu().numpy(), s["corrupted"].cpu().numpy()
        pos, w = s["positions"].cpu().numpy(), s["weights"].cpu().numpy().astype(bool)
        B, L = seqs.shape
        n = (seqs != 0).sum(axis=1)
        count = w.sum(axis=1)
        last_only = (count == np.minimum(n, 1)) & (~w[:, 0] | (pos[:, 0] == L - 1))
        bad += int((~((count == slot_rule(n, cfg)) | last_only)).sum())
        rows = np.repeat(np.arange(B), w.sum(axis=1))
        hit = pos[w]
        bad += int((seqs[rows, hit] == 0).sum())  # a slot on PAD
        slotted = np.zeros((B, L), np.int64)
        np.add.at(slotted, (rows, hit), 1)
        bad += int((slotted > 1).sum())  # a position in two slots
        want = np.where(slotted > 0, mask, seqs)
        bad += int((corrupted != want).sum())
    return bad


def _leaf_gap(got: Dict[str, float], want: Dict[str, float]) -> float:
    """The worst leaf's gap between two norms, against the larger of the
    reference's leaf norm and its median leaf norm."""
    med = statistics.median(want.values())
    return max(abs(got.get(k, 0.0) - w) / max(w, med) for k, w in want.items())


def _gaps(got: dict, want: dict, n: int) -> dict:
    return {"loss_gap": max(abs(a - b) for a, b in zip(got["loss"][:n], want["loss"][:n])),
            "grad_gap": _leaf_gap(got["grad"], want["grad"]),
            "change_gap": _leaf_gap(got["change"], want["change"]),
            "norm_gap": _leaf_gap(got["norm"], want["norm"])}


def check(cfg: dict, traffic: dict, inputs, seed: int, observed: dict, device) -> dict:
    def to(v):
        return v.to(device) if isinstance(v, torch.Tensor) else v and [x.to(device) for x in v]

    n = traffic["check_steps"]
    steps = [{k: to(v) for k, v in s.items()} for s in observed["steps"]]
    want = reference.of(cfg).train_replay(seeded_weights(cfg, seed, device), steps, cfg,
                                          change_after=n)
    return dict(draws_invalid=invalid_draws(cfg, steps), window_nonfinite=observed["nonfinite"],
                **_gaps(observed, want, n))


def reference_steps(cfg: dict, inputs, seed: int, n: int, device) -> List[dict]:
    """``n`` batches and their draws made by plain code from the seed:
    sequences drawn without replacement, each one's slots chosen by the
    published rule (a share ``last_only_prob`` on its last item alone),
    and Bernoulli keep masks."""
    m, B = cfg["model"], cfg["train"]["batch_size"]
    rng = bdata.stream(seed, bdata.SAMPLE)
    g = torch.Generator(device).manual_seed(bdata.torch_seed(seed, bdata.SAMPLE))
    seqs_all = inputs.train_seqs
    P, L, mask = m["max_predictions"], seqs_all.shape[1], inputs.m_items + 1
    N = seqs_all.shape[0]
    order = np.concatenate([rng.permutation(N) for _ in range(-(-n * B // N))])
    out = []
    for i in range(n):
        seqs = seqs_all[order[i * B:(i + 1) * B]]
        pos, w = np.zeros((B, P), np.int64), np.zeros((B, P), bool)
        for b in range(B):
            real = np.flatnonzero(seqs[b])
            if rng.random() < m["last_only_prob"]:
                chosen = real[-1:]
            else:
                chosen = np.sort(rng.choice(real, int(slot_rule(real.size, cfg)), replace=False))
            pos[b, :chosen.size], w[b, :chosen.size] = chosen, True
        corrupted = seqs.copy()
        corrupted[np.repeat(np.arange(B), w.sum(1)), pos[w]] = mask
        keep = [torch.rand((B, L, m["embedding_dim"]), generator=g, device=device)
                < 1.0 - m["dropout_rate"] for _ in range(1 + 2 * m["num_blocks"])]
        out.append({"seqs": torch.as_tensor(seqs, device=device),
                    "corrupted": torch.as_tensor(corrupted, device=device),
                    "positions": torch.as_tensor(pos, device=device),
                    "weights": torch.as_tensor(w, device=device), "keep": keep})
    return out


def control(cfg: dict, traffic: dict, inputs, seed: int, device) -> Dict[str, dict]:
    """The readings of the reference put in the program's place, over a
    first call's steps: with its products in TF32, the precision below
    the configuration's float32 (``control``), with the slots of half of
    each batch's sequences left out of the loss (``half_slots``), and with
    the weight decay left out (``no_decay``); each judged against the
    reference as the program is."""
    ref = reference.of(cfg)
    n = traffic["check_steps"]
    steps = reference_steps(cfg, inputs, seed, traffic["max_steps_per_call"], device)
    weights = seeded_weights(cfg, seed, device)
    want = ref.train_replay(weights, steps, cfg, change_after=n)
    return {name: _gaps(ref.train_replay(weights, steps, cfg, change_after=n, **kw), want, n)
            for name, kw in (("control", dict(tf32=True)), ("half_slots", dict(slot_share=0.5)),
                             ("no_decay", dict(weight_decay=0.0)))}
