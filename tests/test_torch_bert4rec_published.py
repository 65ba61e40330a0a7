"""BERT4Rec as published (Sun et al., CIKM 2019) on the port's normal path,
against the benchmark's plain reference (`benchmark/reference/bert4rec.py`,
plain float32 PyTorch that imports nothing of the port), on the CPU at a
small size with seeded random weights:

- the post-LN encoder (Eqs. 4–5), Eq. 7's tied head and the weighted
  softmax cross-entropy, loss and every gradient;
- the published cloze: its slot counts, no slot on PAD, MASK at every
  slot and nowhere else, the last-item-only samples, uniform positions;
- the decayed, clipped, scheduled Adam (clipping engaged) step for step,
  and the default `ScheduledAdam` step bitwise `torch.optim.Adam`'s;
- a call of ``steps_per_call`` steps going on in the epoch's permutation;
- eval and serving ranking by Eq. 7 (one K1 call a batch and a request);
- a checkpoint of the published options reloaded through
  `seq_model_meta` and served.

Tolerances: both sides compute in float32 on the CPU, in other orders
(the reference's attention per head by `torch.matmul`, the port's by
einsum; its LayerNorm by a division, the port's by rsqrt), so values of
order 1 differ by a few ulps (1e-7); the limits below leave ten times
that and more, and a term left out (a bias, a slot, the clip) moves them
by 1e-3 or more.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.reference import bert4rec as ref
from gsrs_tpu_torch.data.sequences import SequenceData
from gsrs_tpu_torch.models.registry import build_seq_model, seq_model_from_meta, seq_model_meta
from gsrs_tpu_torch.serve_seq import SeqRetriever, load_seq_retriever, main as serve_main
from gsrs_tpu_torch.train.optim import ScheduledAdam, linear_warmup_decay
from gsrs_tpu_torch.train.seq_trainer import SeqTrainer

M, L, D, F, P, B = 60, 12, 16, 64, 4, 8
CFG = {"data": {"m_items": M},
       "model": {"max_len": L, "embedding_dim": D, "num_blocks": 2, "num_heads": 2,
                 "ffn_hidden": F, "dropout_rate": 0.2, "max_predictions": P,
                 "mask_prob": 0.2},
       "train": {"lr": 1e-2, "weight_decay": 0.01, "clip_norm": 5.0, "warmup_steps": 2,
                 "decay_steps": 50, "adam_eps": 1e-6}}
# values of order 1 in float32, summed in other orders: a few ulps (1e-7)
ATOL = 2e-6


def published(**kw):
    args = dict(max_len=L, dim=D, hidden=F, blocks=2, heads=2, dropout=0.2, mask_prob=0.2,
                last_only_prob=0.25, published=P, device="cpu")
    args.update(kw)
    return build_seq_model("bert4rec", M, **args)


def random_weights(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(s, generator=g) * (0.5 if len(s) == 1 else 0.2)
            + (1.0 if k.endswith("_scale") else 0.0)
            for k, s in ref.param_shapes(CFG).items()}


def load(model, weights):
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(weights[k])


def random_seqs(seed=1, rows=B):
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(0, L + 1, (rows,), generator=g)
    lengths[:3] = torch.tensor([0, 1, L])  # empty, one item, full
    seqs = torch.randint(1, M + 1, (rows, L), generator=g)
    return torch.where(torch.arange(L)[None] >= L - lengths[:, None], seqs, 0)


def test_the_published_options_give_the_published_parameters():
    model = published()
    names = set(dict(model.named_parameters()))
    assert names == set(ref.param_shapes(CFG))
    assert {k: tuple(p.shape) for k, p in model.named_parameters()} == ref.param_shapes(CFG)
    default = build_seq_model("bert4rec", M, max_len=L, dim=D, device="cpu")
    assert {"ln_f_scale", "ln_f_bias"} <= set(dict(default.named_parameters()))
    assert not {"head_w", "head_b", "out_bias"} & set(dict(default.named_parameters()))


def test_post_ln_encoder_matches_the_reference():
    model, w = published(), random_weights()
    load(model, w)
    seqs = random_seqs()
    draws = model.draw(torch.Generator().manual_seed(5), seqs)
    got = model.encode(draws.corrupted, draws.keep)
    want = ref.encode(w, draws.corrupted, draws.keep, CFG)
    real = (draws.corrupted != 0)[..., None]  # PAD rows: zeroed by the port, never read
    assert torch.allclose(torch.where(real, got, 0), torch.where(real, want, 0), atol=ATOL)
    # the JAX package's pre-LN encoder, on the same weights, differs by far more
    pre = published(published=0)
    with torch.no_grad():
        for k, p in pre.named_parameters():
            p.copy_(w.get(k, torch.ones_like(p) if k.endswith("scale") else torch.zeros_like(p)))
    off = pre.encode(draws.corrupted, draws.keep)
    assert (torch.where(real, off - want, 0).abs().max()) > 1e-2


def test_eq7_head_and_weighted_softmax_loss_and_gradients():
    model, w = published(), random_weights()
    load(model, w)
    seqs = random_seqs()
    draws = model.draw(torch.Generator().manual_seed(6), seqs)
    loss, aux = model.next_item_bpr_loss(None, seqs, None, draws)
    loss.backward()
    want_loss, want_g = ref.loss_and_grads(w, seqs, draws.corrupted, draws.positions,
                                           draws.weights, draws.keep, CFG)
    assert float(aux["reg"]) == 0.0
    assert abs(float(loss.detach()) - want_loss) < ATOL * 4  # a loss of about ln(60) ≈ 4
    for k, p in model.named_parameters():
        g = want_g[k]
        assert torch.allclose(p.grad, g, atol=1e-6 + 1e-5 * float(g.abs().max())), k
    # b^O is a term of the loss: leaving it out moves it well past the limit
    w0 = dict(w, out_bias=torch.zeros(M))
    without, _ = ref.loss_and_grads(w0, seqs, draws.corrupted, draws.positions,
                                    draws.weights, draws.keep, CFG)
    assert abs(without - want_loss) > 1e-3


def test_the_published_cloze_rule():
    model = published(last_only_prob=0.3)
    seqs = random_seqs(rows=400)
    corrupted, masked, pos, w = model.published_cloze(torch.Generator().manual_seed(7), seqs)
    n = (seqs != 0).sum(1)
    count = w.sum(1)
    rule = torch.minimum(torch.round(n * 0.2).long().clamp(1, P), n)
    last_only = (count == n.clamp(max=1)) & (~w[:, 0] | (pos[:, 0] == L - 1))
    assert bool(((count == rule) | last_only).all())
    assert 0.15 < float(((count == 1) & (rule > 1)).float().mean()) < 0.45  # about 0.3
    assert bool((seqs.gather(1, pos)[w] != 0).all())  # no slot on PAD
    assert bool((pos[~w] == 0).all()) and bool((pos[:, 1:] >= pos[:, :-1])[w[:, 1:]].all())
    slotted = torch.zeros((seqs.shape[0], L + 1), dtype=torch.bool)
    slotted.scatter_(1, torch.where(w, pos, L), True)  # the empty slots into a spare column
    assert torch.equal(slotted[:, :L], masked)
    assert torch.equal(corrupted, torch.where(masked, M + 1, seqs))
    # without last-item-only samples every count is the rule's, the positions uniform
    model = published(last_only_prob=0.0)
    full = torch.randint(1, M + 1, (4000, L), generator=torch.Generator().manual_seed(8))
    _, masked, _, w = model.published_cloze(torch.Generator().manual_seed(9), full)
    assert bool((w.sum(1) == 2).all())  # round(0.2 · 12) = 2
    share = masked.float().mean(0) * L / 2
    assert float((share - 1).abs().max()) < 0.1  # each position 1/6 of the time, ±10%


def test_one_decayed_clipped_scheduled_adam_step():
    g = torch.Generator().manual_seed(3)
    P0 = {"w": torch.randn(5, 4, generator=g), "b": torch.randn(4, generator=g)}
    grads = [{k: torch.randn(v.shape, generator=g) * 3 for k, v in P0.items()}
             for _ in range(3)]
    train = dict(CFG["train"], clip_norm=1.0)
    params = {k: torch.nn.Parameter(v.clone()) for k, v in P0.items()}
    opt = ScheduledAdam(linear_warmup_decay(train["lr"], 2, 50), eps=train["adam_eps"],
                        weight_decay=train["weight_decay"], clip_norm=train["clip_norm"])
    state = opt.init(params)
    p, mom, vel = ({k: v.clone() for k, v in P0.items()},
                   {k: torch.zeros_like(v) for k, v in P0.items()},
                   {k: torch.zeros_like(v) for k, v in P0.items()})
    for t, gr in enumerate(grads, start=1):
        norm = float(torch.sqrt(sum((x ** 2).sum() for x in gr.values())))
        assert norm > 3 * train["clip_norm"]  # the clip engages
        for k, x in gr.items():
            params[k].grad = x.clone()
        state = opt.step(params, state)
        ref.adamw_step(p, mom, vel, ref.clipped(gr, train["clip_norm"]), t,
                       ref.schedule(t - 1, train), train)
        for k in P0:  # a parameter of order 1, moved by about lr: ulps of 1
            assert torch.allclose(params[k].detach(), p[k], atol=1e-6, rtol=0), (t, k)
    assert state.count == 3 and not torch.equal(params["w"].detach(), P0["w"])
    assert ref.schedule(0, train) == 0.0  # the first update moves nothing but the decay


def test_the_default_scheduled_adam_step_is_torch_adam_bitwise():
    g = torch.Generator().manual_seed(4)
    P0 = {"a": torch.randn(7, 3, generator=g), "b": torch.randn(3, generator=g)}
    mine = {k: torch.nn.Parameter(v.clone()) for k, v in P0.items()}
    theirs = {k: torch.nn.Parameter(v.clone()) for k, v in P0.items()}
    opt = ScheduledAdam(lambda count: float(np.float32(1e-2)))
    state = opt.init(mine)
    assert type(state.optimizer) is torch.optim.Adam and len(state.optimizer.param_groups) == 1
    adam = torch.optim.Adam(list(theirs.values()), lr=float(np.float32(1e-2)),
                            betas=(0.9, 0.999), eps=1e-8)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in P0.items()}
        for k, x in grads.items():
            mine[k].grad, theirs[k].grad = x.clone(), x.clone()
        state = opt.step(mine, state)
        adam.step()
        adam.zero_grad(set_to_none=True)
    for k in P0:
        assert torch.equal(mine[k], theirs[k])


def _data(rows=40, seed=2):
    seqs = random_seqs(seed, rows).numpy()
    seqs[:3] = np.arange(1, L + 1)  # no empty sequence in training
    hist = {u: row[row > 0].astype(np.int64) for u, row in enumerate(seqs)}
    targets = np.random.default_rng(seed).integers(1, M + 1, rows)
    return SequenceData("tiny", rows, M, L, seqs, seqs, np.arange(rows), targets, hist)


def _trainer(model, data, **kw):
    t = CFG["train"]
    return SeqTrainer(model, data, batch_size=B, lr=t["lr"], seed=11, topks=(5,), eval_batch=16,
                      warmup_steps=t["warmup_steps"], decay_steps=t["decay_steps"],
                      weight_decay=t["weight_decay"], clip_norm=t["clip_norm"],
                      adam_eps=t["adam_eps"], device="cpu", **kw)


@pytest.fixture
def deterministic():
    """The CPU's ``index_put_`` with accumulation adds in a thread-dependent
    order unless asked not to: the bitwise comparisons need one order."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def test_calls_of_a_few_steps_go_on_in_the_epochs_permutation(deterministic):
    data = _data()  # 5 steps an epoch
    runs = []
    for cap in (None, 3):
        tr = _trainer(published(), data)
        tr.steps_per_call = cap
        state = tr.init_state()
        losses = []
        for _ in range(2 if cap is None else 3):  # 10 steps, then 9
            state, loss = tr.train_epoch(state)
            losses.append(loss)
        runs.append((state, {k: p.detach().clone() for k, p in state.params.items()}))
    (whole, p_whole), (capped, p_capped) = runs
    assert (whole.epoch, whole.step) == (2, 0) and (capped.epoch, capped.step) == (1, 4)
    tr = _trainer(published(), data)
    tr.steps_per_call = 1
    state, _ = tr.train_epoch(SeqTrainer.restore(tr, tr.init_state(), _ckpt(capped, p_capped)))
    assert (state.epoch, state.step) == (2, 0)
    for k, p in state.params.items():
        assert torch.equal(p.detach(), p_whole[k]), k
    with pytest.raises(ValueError, match="whole epochs"):
        tr.fit(state, epochs=3)


def _ckpt(state, params):
    from gsrs_tpu_torch.train.optim import optimizer_state_dict

    return {"params": params, "opt_state": optimizer_state_dict(state.opt_state, state.params),
            "epoch": state.epoch, "step": state.step}


def _reference_top(model, w, data, k):
    """The top-k of Eq. 7's scores by the reference, history masked."""
    seqs = torch.as_tensor(data.eval_seqs)
    query = torch.cat([seqs[:, 1:], torch.full((seqs.shape[0], 1), M + 1)], 1)
    h = ref.encode(w, query, None, CFG)[:, -1]
    with torch.no_grad():
        scores = ref.head_logits(w, h, w["item_emb"][1:M + 1])
    for u, hist in data.user_hist_sets.items():
        scores[u, torch.as_tensor(hist) - 1] = -1e9
    return scores


def test_eval_and_serving_rank_by_eq7(monkeypatch):
    from gsrs_tpu_torch import serve_seq
    from gsrs_tpu_torch.train import seq_trainer

    data, w = _data(), random_weights(7)
    tr = _trainer(published(), data)
    load(tr.model, w)
    calls = []

    def counted(module):
        real = module.masked_scores

        def k1(q, items, rows, *a, **kw):
            calls.append((q.shape[1], items.shape[1]))
            return real(q, items, rows, *a, **kw)

        monkeypatch.setattr(module, "masked_scores", k1)

    counted(seq_trainer)
    counted(serve_seq)
    scores = _reference_top(tr.model, w, data, 5)
    want = scores.topk(5, dim=1)
    tops = torch.cat([top for _, _, _, top in tr._eval_batches(5)])[:len(data.eval_users)]
    assert calls == [(D + 4, D + 4)] * 3  # one K1 call a batch of 16: (q ‖ 1 ‖ 0 0 0)
    got = scores.gather(1, tops)
    assert torch.allclose(got, want.values, atol=1e-5)  # the same ranks, ties aside
    r = SeqRetriever(tr.model, batch_size=1, device="cpu")
    calls.clear()
    sessions = [list(data.eval_seqs[u][data.eval_seqs[u] > 0] - 1) for u in range(3)]
    items, vals = r.recommend(sessions, k=5)
    assert len(calls) == 3  # one K1 call a request of one session
    assert torch.allclose(torch.as_tensor(vals), want.values[:3], atol=1e-5)
    assert torch.allclose(scores[:3].gather(1, torch.as_tensor(items).long()), want.values[:3],
                          atol=1e-5)


def test_a_published_checkpoint_reloads_and_serves(tmp_path, deterministic):
    data = _data()
    tr = _trainer(published(), data)
    ck = str(tmp_path / "ck")
    state = tr.fit(epochs=2, checkpoint_dir=ck, eval_every=1, verbose=False)
    with open(os.path.join(ck, "model_meta.json")) as f:
        meta = json.load(f)
    assert meta == seq_model_meta(tr.model)
    assert meta["published"] == P
    again = seq_model_from_meta(meta, device="cpu")
    assert again.cfg.published == P
    resumed = _trainer(again, data)
    back = resumed.fit(epochs=2, checkpoint_dir=ck, resume=True, verbose=False)
    assert back.epoch == state.epoch
    for k, p in back.params.items():
        assert torch.equal(p, state.params[k]), k
    out = str(tmp_path / "seq.npz")
    serve_main(["export", "--checkpoint_dir", ck, "--out", out, "--device", "cpu"])
    served = load_seq_retriever(out, device="cpu")
    live = SeqRetriever(tr.model, batch_size=64, device="cpu")
    session = [[3, 17, 42], [5]]
    a, sa = served.recommend(session, k=7)
    b, sb = live.recommend(session, k=7)
    assert np.array_equal(a, b) and np.allclose(sa, sb, atol=1e-6)
    # the defaults' meta keeps the JAX package's keys alone
    assert set(seq_model_meta(build_seq_model("bert4rec", M, device="cpu"))) == {
        "kind", "m_items", "max_len", "dim", "hidden", "blocks", "heads"}


def test_the_cli_published_flag_sets_the_model_and_the_optimizer():
    from gsrs_tpu_torch.seq_cli import PUBLISHED_CLOZE, PUBLISHED_OPTIM, main as seq_main

    trainer, state = seq_main(["--synthetic", "--model", "bert4rec", "--published", str(P),
                               "--max_len", str(L), "--dim", str(D), "--epochs", "1",
                               "--eval_every", "1"], device="cpu")
    c, opt = trainer.model.cfg, trainer.optimizer
    assert (c.published, c.mask_prob, c.last_only_prob) == (
        P, PUBLISHED_CLOZE["mask_prob"], PUBLISHED_CLOZE["last_only_prob"])
    assert (opt.weight_decay, opt.clip_norm, opt.eps) == (
        PUBLISHED_OPTIM["weight_decay"], PUBLISHED_OPTIM["clip_norm"],
        PUBLISHED_OPTIM["adam_eps"])
    assert opt.schedule(0) == 0.0 and state.epoch == 1
    with pytest.raises(ValueError, match="BERT4Rec's option"):
        seq_main(["--synthetic", "--model", "sasrec", "--published", str(P), "--epochs", "1"],
                 device="cpu")
