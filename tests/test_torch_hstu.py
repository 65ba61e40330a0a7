"""HSTU on the port's sequential path (`gsrs_tpu_torch.models.hstu`) against
the plain reference `benchmark/reference/hstu.py`, on the CPU at a tiny
size with seeded random weights: the block's forward, the loss and every
leaf's gradient; causality and padding; the bias's indices and buckets on
hand-made times; the exclusion of a negative equal to its target; three
`SeqTrainer` steps on recorded draws; times through `SequenceData` and the
MovieLens converter; `seq_cli --model hstu` with a checkpoint that
reloads and an eval that ranks by z against ê; `serve_seq`'s refusal; the
spans and ``HEAD_ROWS``; and BERT4Rec's step unchanged by the times path.
Marked ``gpu``: captured and replayed HSTU steps give the eager steps'
bits."""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.reference import hstu as ref  # noqa: E402
from gsrs_tpu_torch.data.sequences import SequenceData, sequences_from_interactions  # noqa: E402
from gsrs_tpu_torch.models import hstu  # noqa: E402
from gsrs_tpu_torch.models.registry import build_seq_model, seq_model_from_meta  # noqa: E402
from gsrs_tpu_torch.train.seq_trainer import (  # noqa: E402
    StepDraws, SeqTrainer, head_row_counts,
)
from gsrs_tpu_torch.utils.timer import spans  # noqa: E402

M, N, D, H, DH, L, B = 50, 10, 16, 2, 4, 2, 4
K = hstu.NEGATIVES
CFG = {"model": {"max_len": N, "embedding_dim": D, "num_blocks": L, "num_heads": H,
                 "head_dim": DH, "dropout_rate": 0.2, "num_negatives": K,
                 "temperature": hstu.TEMPERATURE},
       "data": {"m_items": M},
       "train": {"lr": 1e-3, "adam_betas": [0.9, 0.98], "adam_eps": 1e-8}}


def _model(device="cpu", dropout=0.2, seed=3):
    model = build_seq_model("hstu", M, max_len=N, dim=D, hidden=DH, blocks=L, heads=H,
                            dropout=dropout, device=device,
                            generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():  # random weights, so every term shows
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    return model


def _batch(seed=0, b=B, lengths=None):
    """(seqs, times) unshifted (the targets), left-padded, times rising."""
    g = np.random.default_rng(seed)
    seqs, times = np.zeros((b, N), np.int64), np.zeros((b, N), np.int64)
    for r in range(b):
        n = lengths[r] if lengths is not None else int(g.integers(2, N + 1))
        seqs[r, N - n:] = g.integers(1, M + 1, n)
        times[r, N - n:] = 10**9 + np.cumsum(g.integers(1, 10**7, n))
    return torch.as_tensor(seqs), torch.as_tensor(times)


def _draws(seqs, seed=0, dropout=True):
    g = torch.Generator().manual_seed(seed)
    neg = torch.randint(1, M + 1, (*seqs.shape, K), generator=g)
    neg = torch.where(seqs[..., None] == 0, 0, neg)
    keep = None
    if dropout:
        keep = [torch.rand((*seqs.shape, w), generator=g) < 0.8 for w in [D] + [H * DH] * L]
    return neg, keep


def _shift(x):
    out = torch.zeros_like(x)
    out[:, 1:] = x[:, :-1]
    return out


def _port_loss(model, seqs, times, neg, keep):
    for p in model.parameters():
        p.grad = None
    loss, _ = model.next_item_bpr_loss(_shift(seqs), seqs, neg, hstu.HSTUDraws(keep),
                                       times=(_shift(times), times))
    loss.backward()
    return float(loss.detach()), {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("dropout", [False, True], ids=["eval", "dropout"])
def test_forward_loss_and_every_gradient_match_the_reference(dropout):
    model = _model()
    seqs, times = _batch()
    neg, keep = _draws(seqs, dropout=dropout)
    P = {k: p.detach() for k, p in model.named_parameters()}
    got = model.encode(_shift(seqs), _shift(times), times, keep)
    want = ref.encode(P, _shift(seqs), _shift(times), times, keep, CFG)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    loss, grads = _port_loss(model, seqs, times, neg, keep)
    want_loss, want_grads = ref.loss_and_grads(P, seqs, times, neg, keep, CFG)
    assert loss == pytest.approx(want_loss, rel=1e-6)
    assert set(grads) == set(want_grads) == set(ref.param_shapes(
        dict(CFG, data={"m_items": M})))
    for k, g in want_grads.items():
        assert torch.allclose(grads[k], g, rtol=1e-4, atol=1e-6), k
        assert float(g.norm()) > 0, k  # every leaf takes part


def test_a_later_slot_changes_no_earlier_output():
    model = _model()
    seqs, times = _batch(lengths=[N] * B)
    inp, t_in = _shift(seqs), _shift(times)
    base = model.encode(inp, t_in, times)
    j = 6
    inp2, t_in2, t_tgt2 = inp.clone(), t_in.clone(), times.clone()
    inp2[:, j:] = (inp2[:, j:] % M) + 1
    t_in2[:, j:] += 12345
    t_tgt2[:, j:] += 999
    after = model.encode(inp2, t_in2, t_tgt2)
    assert torch.allclose(after[:, :j], base[:, :j], rtol=0, atol=1e-6)
    assert not torch.allclose(after[:, j:], base[:, j:])


def test_what_the_pad_slots_hold_changes_no_real_output():
    model = _model()
    seqs, times = _batch(lengths=[3, 5, 7, 9])
    inp, t_in = _shift(seqs), _shift(times)
    base = model.encode(inp, t_in, times)
    pad = inp == 0
    noisy_in = torch.where(pad, torch.randint(0, 10**9, t_in.shape), t_in)
    noisy_tgt = torch.where(seqs == 0, torch.randint(0, 10**9, times.shape), times)
    with torch.no_grad():
        model.item_emb[0] += 5.0
    after = model.encode(inp, noisy_in, noisy_tgt)
    real = ~pad
    assert torch.allclose(after[real], base[real], rtol=0, atol=1e-6)
    # and PAD keys do reach real slots where the mask leaves them in
    P = {k: p.detach() for k, p in model.named_parameters()}
    leaky = ref.encode(P, inp, t_in, times, None, CFG, pad_keys=True)
    assert not torch.allclose(leaky[real], base[real], atol=1e-4)


def test_the_bias_indices_and_buckets_on_hand_made_times():
    day, year = 86_400, 31_557_600
    t_in = torch.tensor([[0, 1_000, 1_000, 1_000 + day]])
    t_tgt = torch.tensor([[1_000, 1_000, 1_000 + day, 1_000 + 20 * year]])
    b = hstu.bucket_ids(t_in, t_tgt)
    want = [[math.floor(math.log(max(abs(t_tgt[0, i] - t_in[0, j]), 1)) / 0.301)
             for j in range(4)] for i in range(4)]
    assert b[0].tolist() == [[min(max(w, 0), 128) for w in row] for row in want]
    assert b[0, 3, 2] == 67  # 20 years
    assert b[0, 1, 1] == 0 and b[0, 0, 0] == math.floor(math.log(1000) / 0.301)
    assert torch.equal(hstu.bucket_ids(t_in, t_tgt), ref.buckets(t_in, t_tgt))
    assert int(hstu.bucket_ids(torch.tensor([[0]]), torch.tensor([[10**18]]))) == 128
    # the eval query's layout: τ is the next slot's time, the last one's own repeated
    assert hstu.target_times(torch.tensor([[5, 7, 9]])).tolist() == [[7, 9, 9]]
    # p's index N − 1 + j − i, and w by bucket, shared by the heads
    model = _model()
    with torch.no_grad():
        model.b0_pos_w.copy_(torch.arange(2 * N - 1, dtype=torch.float32))
        model.b0_ts_w.copy_(1000.0 * torch.arange(129, dtype=torch.float32))
    bk = torch.randint(0, 129, (1, N, N))
    rab = model.relative_bias(0, bk)
    i, j = torch.meshgrid(torch.arange(N), torch.arange(N), indexing="ij")
    assert torch.equal(rab[0], (N - 1 + j - i).float() + 1000.0 * bk[0].float())


def test_the_trainer_shifts_the_times_as_the_input():
    model = _model(dropout=0.0)
    seen = {}
    whole = model.next_item_bpr_loss

    def spy(inp, pos, neg, draws=None, times=None):
        seen.update(inp=inp, pos=pos, times=times)
        return whole(inp, pos, neg, draws, times=times)

    model.next_item_bpr_loss = spy
    seqs, times = _batch()
    tr = SeqTrainer(model, _data(seqs, times), batch_size=B, device="cpu")
    state = tr.init_state()
    neg, _ = _draws(seqs, dropout=False)
    tr.run_steps(state, seqs[None], [StepDraws(neg, hstu.HSTUDraws(None))], times[None])
    assert torch.equal(seen["inp"], _shift(seqs)) and torch.equal(seen["pos"], seqs)
    assert torch.equal(seen["times"][0], _shift(times)) and torch.equal(seen["times"][1], times)


def test_a_negative_equal_to_its_target_is_excluded():
    model = _model()
    seqs, times = _batch()
    neg, keep = _draws(seqs)
    real = seqs != 0
    c = K // 6  # every real slot's first c negatives collide (a sixth, as at K = 6)
    neg[..., :c] = torch.where(real, seqs, 0)[..., None]
    logits = torch.zeros((*seqs.shape, K + 1))
    out = model.exclude_collisions(logits, seqs, neg)
    assert bool((out[..., 1:1 + c][real] == hstu.COLLISION_LOGIT).all())
    want = torch.where(neg == seqs[..., None], hstu.COLLISION_LOGIT, 0.0)
    assert bool((out[..., 0] == 0).all()) and torch.equal(out[..., 1:], want)
    P = {k: p.detach() for k, p in model.named_parameters()}
    loss, _ = _port_loss(model, seqs, times, neg, keep)
    assert loss == pytest.approx(ref.loss_and_grads(P, seqs, times, neg, keep, CFG)[0],
                                 rel=1e-6)
    kept, _ = ref.loss_and_grads(P, seqs, times, neg, keep, CFG, keep_collisions=True)
    assert abs(kept - loss) > 1e-3


def _data(seqs, times, name="hand"):
    seqs = np.asarray(seqs)
    times = None if times is None else np.asarray(times)
    n = len(seqs)
    return SequenceData(name=name, n_users=n, m_items=M, max_len=N, train_seqs=seqs,
                        eval_seqs=seqs, eval_users=np.arange(n),
                        eval_targets=np.full(n, 1, np.int32),
                        user_hist_sets={u: np.zeros(0, np.int64) for u in range(n)},
                        train_times=times, eval_times=times)


def test_three_trainer_steps_match_the_reference_on_recorded_draws():
    model = _model()
    seqs, times = _batch(b=3 * B, seed=5)
    tr = SeqTrainer(model, _data(seqs, times), batch_size=B, lr=1e-3, adam_betas=(0.9, 0.98),
                    device="cpu")
    state = tr.init_state()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(9)) * 0.3)
    P0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    batches, batch_times = seqs.view(3, B, N), times.view(3, B, N)
    draws, steps = [], []
    for i in range(3):
        neg, keep = _draws(batches[i], seed=i)
        draws.append(StepDraws(neg, hstu.HSTUDraws(keep)))
        steps.append({"seqs": batches[i], "times": batch_times[i], "neg": neg, "keep": keep})
    state, losses = tr.run_steps(state, batches, draws, batch_times)
    want = ref.train_replay(P0, steps, CFG)
    assert losses.tolist() == pytest.approx(want["loss"], rel=1e-5)
    for k, p in model.named_parameters():
        assert float((p.detach() - P0[k]).norm()) == pytest.approx(want["change"][k], rel=1e-3,
                                                                   abs=1e-6), k
        assert torch.allclose(p.detach(), want["state"][0][k], rtol=1e-4, atol=1e-5), k


def _ratings(path, n_users=30, seed=0):
    """An ML-1M ``ratings.dat`` whose lines are out of time order."""
    g = np.random.default_rng(seed)
    rows = []
    for u in range(1, n_users + 1):
        n = int(g.integers(6, 18))
        items = g.choice(np.arange(1, M + 1), n, replace=False)
        ts = 900_000_000 + np.sort(g.choice(10**8, n, replace=False))
        rows += [(u, int(i), 5, int(t)) for i, t in zip(items, ts)]
    order = g.permutation(len(rows))
    with open(path, "w") as f:
        for k in order:
            f.write("::".join(map(str, rows[k])) + "\n")
    return rows


def test_times_round_trip_through_the_movielens_converter(tmp_path):
    from gsrs_tpu_torch.data.dataset import load_dataset
    from gsrs_tpu_torch.data.movielens import prepare_movielens

    rows = _ratings(tmp_path / "ratings.dat")
    prepare_movielens(str(tmp_path / "ratings.dat"), str(tmp_path / "ml"), min_interactions=5,
                      split="leave_last")
    data = load_dataset(str(tmp_path / "ml"))
    seq = sequences_from_interactions(data, max_len=N)
    item_of = {int(a): int(b) for a, b in np.loadtxt(tmp_path / "ml" / "item_list.txt",
                                                     skiprows=1, dtype=np.int64)}
    user_of = {int(a): int(b) for a, b in np.loadtxt(tmp_path / "ml" / "user_list.txt",
                                                     skiprows=1, dtype=np.int64)}
    time_of = {(user_of[u], item_of[i]): t for u, i, _, t in rows}
    assert seq.train_times is not None and seq.eval_times is seq.train_times
    for k, u in enumerate(seq.eval_users):
        real = seq.train_seqs[k] != 0
        want = [time_of[(int(u), int(i) - 1)] for i in seq.train_seqs[k][real]]
        assert seq.train_times[k][real].tolist() == want
        assert (np.diff(want) > 0).all() and (seq.train_times[k][~real] == 0).all()


def test_seq_cli_trains_evaluates_and_reloads_hstu(tmp_path):
    from gsrs_tpu_torch import seq_cli
    from gsrs_tpu_torch.data.movielens import prepare_movielens
    from gsrs_tpu_torch.train.checkpoint import CheckpointManager

    _ratings(tmp_path / "ratings.dat", n_users=40)
    prepare_movielens(str(tmp_path / "ratings.dat"), str(tmp_path / "data" / "ml"),
                      min_interactions=5, split="leave_last")
    ck = str(tmp_path / "ck")
    argv = ["--data_root", str(tmp_path / "data"), "--dataset", "ml", "--model", "hstu",
            "--max_len", str(N), "--dim", str(D), "--hidden", str(DH), "--blocks", str(L),
            "--heads", str(H), "--batch", "8", "--epochs", "2",
            "--eval_every", "1", "--topks", "[5]", "--checkpoint_dir", ck]
    tr, state = seq_cli.main(argv, device="cpu")
    assert tr.optimizer.b2 == 0.98 and state.epoch == 2
    with open(os.path.join(ck, "model_meta.json")) as f:
        meta = json.load(f)
    assert meta["kind"] == "hstu" and meta["hidden"] == DH and meta["heads"] == H
    model = seq_model_from_meta(meta, device="cpu")
    model.load_state_dict(CheckpointManager(ck).restore(os.path.join(ck, "last"))["params"])
    for k, p in tr.model.named_parameters():
        assert torch.equal(getattr(model, k), p.detach()), k
    # the eval ranks by z at the last slot against ê, the history masked
    got = tr.evaluate(state)
    data = tr.data
    with torch.no_grad():
        q = model.scoring_query(torch.as_tensor(data.eval_seqs).long(),
                                torch.as_tensor(data.eval_times))
        P = {k: p.detach() for k, p in model.named_parameters()}
        t = torch.as_tensor(data.eval_times)
        x = ref.encode(P, torch.as_tensor(data.eval_seqs).long(), t,
                       torch.cat([t[:, 1:], t[:, -1:]], dim=1), None,
                       dict(CFG, model=dict(CFG["model"], dropout_rate=0.0)))
        assert torch.allclose(q, ref.l2_normalized(x[:, -1]), atol=1e-5)
        scores = q @ ref.l2_normalized(P["item_emb"][1:]).T
    hits = 0
    for k, u in enumerate(data.eval_users):
        s = scores[k].clone()
        s[torch.as_tensor(data.user_hist_sets[int(u)]) - 1] = -float("inf")
        hits += int(int(data.eval_targets[k]) - 1 in torch.topk(s, 5).indices.tolist())
    assert got["recall@5"] == pytest.approx(hits / len(data.eval_users))


def test_seq_cli_stops_on_a_dataset_without_times(tmp_path):
    from gsrs_tpu_torch import seq_cli

    with pytest.raises(SystemExit, match="time"):
        seq_cli.main(["--synthetic", "--model", "hstu", "--epochs", "0"], device="cpu")


def test_serve_seq_refuses_hstu(tmp_path):
    from gsrs_tpu_torch.serve_seq import SeqRetriever

    with pytest.raises(ValueError, match="not served"):
        SeqRetriever(_model(), device="cpu")


def test_spans_and_the_head_row_counter_are_recorded():
    model = _model()
    seqs, times = _batch(b=2 * B)
    tr = SeqTrainer(model, _data(seqs, times), batch_size=B, device="cpu")
    tr.steps_per_call = 2
    state = tr.init_state()
    before = head_row_counts()["rows"]
    with profile(activities=[ProfilerActivity.CPU]):
        tr.train_epoch(state)
    assert head_row_counts()["rows"] - before == 2 * B * N
    tape = spans()
    by = {}
    for s in tape:
        by.setdefault(s.name, []).append(s)
    names = {s.id: s.name for s in tape}
    assert [s.attrs["shape"] for s in by["hstu.negatives"]] == [(B * N, K)] * 2
    assert all(names[s.parent] == "train.sample" for s in by["hstu.negatives"])
    assert [s.attrs["shape"] for s in by["hstu.rab"]] == [(B, N, 129)] * 2
    assert [s.attrs["shape"] for s in by["hstu.block"]] == [(B, H, N, DH)] * (2 * L)
    assert [s.attrs["shape"] for s in by["seq.head"]] == [(B * N, K, D)] * 2
    assert len(by["seq.encode"]) == 2


def test_bert4rec_steps_carry_no_times():
    model = build_seq_model("bert4rec", M, max_len=N, dim=D, hidden=2 * D, blocks=1, heads=2,
                            published=3, mask_prob=0.2, last_only_prob=0.1, device="cpu")
    seqs, _ = _batch(b=2 * B)
    data = _data(seqs, None)
    tr = SeqTrainer(model, data, batch_size=B, device="cpu")
    assert not tr.uses_times and tr.train_times is None and tr._batch_times(0, 0) is None
    draws = tr.draw_step(tr._batch(0, 0), tr.step_generator(0, 0))
    assert draws.neg.shape == (B, N)
    with pytest.raises(ValueError, match="time"):
        SeqTrainer(_model(), data, batch_size=B, device="cpu")


def test_hstu_is_not_sharded():
    from gsrs_tpu_torch.parallel.mesh import single_device_mesh

    seqs, times = _batch()
    with pytest.raises(ValueError, match="not sharded"):
        SeqTrainer(_model(), _data(seqs, times), batch_size=B, device="cpu",
                   mesh=single_device_mesh(torch.device("cpu")))


@pytest.mark.gpu
def test_replayed_hstu_steps_give_the_eager_steps_bits(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph is captured and replayed only there")
    from gsrs_tpu_torch.train.seq_trainer import step_graph_counts

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    seqs, times = _batch(b=4 * B, seed=7)

    def run(capture):
        model = _model(device=dev)
        tr = SeqTrainer(model, _data(seqs, times), batch_size=B, lr=1e-3,
                        adam_betas=(0.9, 0.98), seed=5, device=dev)
        if not capture:
            monkeypatch.setattr(tr, "_captures", lambda: False)
        tr.steps_per_call = 6
        state = tr.init_state()
        losses = []
        for _ in range(2):
            state, loss = tr.train_epoch(state)
            losses.append(loss)
        return losses, {k: p.detach().clone() for k, p in model.named_parameters()}

    before = step_graph_counts()
    losses, got = run(True)
    counts = step_graph_counts()
    assert counts["captures"] - before["captures"] == 1
    assert counts["replays"] - before["replays"] == 12 - 3 - 1
    eager_losses, want = run(False)
    assert losses == eager_losses
    for k, p in want.items():
        assert torch.equal(got[k].view(torch.int32), p.view(torch.int32)), k
