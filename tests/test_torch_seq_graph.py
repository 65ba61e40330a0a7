"""The sequential trainer's step replayed from a CUDA graph
(`gsrs_tpu_torch.train.seq_trainer`'s module note).

On the CPU the trainer never captures: `ScheduledAdam` steps, the counter
of captures and replays stays where it was, and a `train_epoch` call
gives the loss and parameters of `_step` called step by step, as the
trainer called it before it had graphs (a mesh:
`tests/test_torch_seq_mesh.py`). `CapturableAdam`'s checkpoints keep
`ScheduledAdam`'s form, and load back into it as capturable.

Marked ``gpu`` (run on the card), for SASRec, GRU4Rec and the published
BERT4Rec under a warm-up-and-decay schedule with weight decay and a clip
that acts: two calls whose steps span the warm-up, the capture and
replays give the same bits, and count the same kernel launches, as the
same steps with capture off (the private predicate patched); the counter
reads one capture and the steps after it as replays; a checkpoint written
after replays and restored into a fresh trainer goes on equal to the run
that never stopped; and a profile of replayed steps lists by name every
kernel of the same steps run eagerly (the benchmark's readers find the
kernels they time by name)."""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from gsrs_tpu_torch.data.sequences import synthetic_markov_sequences
from gsrs_tpu_torch.kernels import launch_counts, launches_since
from gsrs_tpu_torch.models.registry import build_seq_model
from gsrs_tpu_torch.train.checkpoint import CheckpointManager
from gsrs_tpu_torch.train.optim import CapturableAdam, ScheduledAdam, optimizer_state_dict
from gsrs_tpu_torch.train.seq_trainer import WARMUP_STEPS, SeqTrainer, step_graph_counts

M, L, D, B, P = 100, 12, 16, 16, 3
DATA = synthetic_markov_sequences(n_users=120, m_items=M, n_clusters=5, max_len=L, seed=0)
KINDS = ["sasrec", "gru4rec", "bert4rec"]
CALL = 6  # steps a call: two calls span the warm-up, the capture and replays


def _trainer(kind, device):
    kw = dict(published=P, mask_prob=0.2, last_only_prob=0.1) if kind == "bert4rec" else {}
    model = build_seq_model(kind, M, max_len=L, dim=D, hidden=2 * D, blocks=2,
                            heads=1 if kind == "gru4rec" else 2, dropout=0.2, device=device,
                            generator=torch.Generator().manual_seed(1), **kw)
    tr = SeqTrainer(model, DATA, batch_size=B, lr=1e-2, seed=5, topks=(10,), eval_batch=16,
                    warmup_steps=3, decay_steps=40, weight_decay=0.01, clip_norm=0.05,
                    adam_eps=1e-6, device=device)
    tr.steps_per_call = CALL
    return tr


def _calls(tr, state, n=2):
    """``n`` calls → (state, their mean losses, the parameters after)."""
    losses = []
    for _ in range(n):
        state, loss = tr.train_epoch(state)
        losses.append(loss)
    return state, losses, {k: p.detach().clone() for k, p in state.params.items()}


def _assert_same_bits(got, want):
    assert set(got) == set(want)
    for k, p in want.items():
        assert torch.equal(got[k].view(torch.int32), p.view(torch.int32)), k


@pytest.fixture
def deterministic():
    """The CPU's ``index_put_`` with accumulation adds in a thread-dependent
    order unless asked not to: the bitwise comparisons need one order."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("kind", KINDS)
def test_the_cpu_steps_eagerly_as_before(kind, deterministic):
    tr = _trainer(kind, "cpu")
    assert type(tr.optimizer) is ScheduledAdam and not tr._captures()
    before = step_graph_counts()
    state, (mean,), got = _calls(tr, tr.init_state(), 1)
    assert step_graph_counts() == before and state.opt_state.count == CALL
    old = _trainer(kind, "cpu")
    old_state, losses = old.init_state(), []
    for i, seqs in enumerate(old.epoch_batches(0)[:CALL]):
        old_state, loss = old._step(old_state, seqs, old.draw_step(seqs, old.step_generator(0, i)))
        losses.append(loss)
    assert float(torch.stack(losses).mean()) == mean
    _assert_same_bits(got, {k: p.detach() for k, p in old_state.params.items()})


def test_capturable_adam_checkpoints_keep_the_plain_form():
    g = torch.Generator().manual_seed(2)
    params = {"w": torch.nn.Parameter(torch.randn(4, 3, generator=g)),
              "b": torch.nn.Parameter(torch.randn(3, generator=g))}
    plain = ScheduledAdam(lambda count: 1e-3, weight_decay=0.01)
    state = plain.init(params)
    for p in params.values():
        p.grad = torch.randn(p.shape, generator=g)
    want = optimizer_state_dict(plain.step(params, state), params)["torch"]
    cap = CapturableAdam(lambda count: 1e-3, weight_decay=0.01, device=torch.device("cpu"))
    cstate = cap.init(params)
    cstate.optimizer.load_state_dict(want)
    groups = cstate.optimizer.param_groups
    assert all(g_["capturable"] and isinstance(g_["lr"], torch.Tensor) for g_ in groups)
    assert all(s["step"].dtype == torch.float32 for s in cstate.optimizer.state.values())
    cap.set_lr(cstate)
    assert all(float(g_["lr"]) == float(np.float32(1e-3)) for g_ in groups)
    got = optimizer_state_dict(cstate, params)["torch"]
    for mine, theirs in zip(got["param_groups"], want["param_groups"], strict=True):
        assert mine == dict(theirs, lr=float(np.float32(1e-3)))
    assert set(got["state"]) == set(want["state"])
    for i, s in want["state"].items():
        assert set(got["state"][i]) == set(s)
        for name, t in s.items():
            assert torch.equal(got["state"][i][name], t), name


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph is captured and replayed only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_replayed_steps_give_the_eager_steps_bits(cuda, kind, monkeypatch):
    tr = _trainer(kind, cuda)
    assert type(tr.optimizer) is CapturableAdam and tr._captures()
    before, launched = step_graph_counts(), launch_counts()
    _, losses, got = _calls(tr, tr.init_state())
    launches = launches_since(launched)
    counts = step_graph_counts()
    assert counts["captures"] - before["captures"] == 1
    assert counts["replays"] - before["replays"] == 2 * CALL - WARMUP_STEPS - 1
    eager = _trainer(kind, cuda)
    monkeypatch.setattr(eager, "_captures", lambda: False)
    before, launched = step_graph_counts(), launch_counts()
    _, eager_losses, want = _calls(eager, eager.init_state())
    assert step_graph_counts() == before
    assert launches == launches_since(launched) and launches["gather_rows_grad"] >= 2 * CALL
    assert losses == eager_losses
    _assert_same_bits(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_a_checkpoint_after_replays_resumes_equal(cuda, kind, tmp_path):
    tr = _trainer(kind, cuda)
    state, _, _ = _calls(tr, tr.init_state())
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save_last(tr.ckpt_state(state))
    before = step_graph_counts()["replays"]
    _, on, want = _calls(tr, state)  # the run that never stopped: replays alone
    assert step_graph_counts()["replays"] - before == 2 * CALL
    fresh = _trainer(kind, cuda)
    state = fresh.restore(fresh.init_state(), ckpt.restore(str(tmp_path / "last")))
    assert state.opt_state.count == 2 * CALL
    _, resumed, got = _calls(fresh, state)
    assert resumed == on
    _assert_same_bits(got, want)


def _kernel_names(tr, state):
    """The names of the kernels a profiled call of ``tr`` runs."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tr.train_epoch(state)
        torch.cuda.synchronize()
    return {e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() != DeviceType.CPU and e.duration_ns() > 0
            and not e.name().startswith(("Memcpy", "Memset"))}


@pytest.mark.gpu
def test_a_profile_of_replayed_steps_lists_their_kernels(cuda, monkeypatch):
    tr = _trainer("bert4rec", cuda)
    state, _, _ = _calls(tr, tr.init_state(), 1)
    before = step_graph_counts()["replays"]
    replayed = _kernel_names(tr, state)
    assert step_graph_counts()["replays"] - before == CALL
    eager = _trainer("bert4rec", cuda)
    monkeypatch.setattr(eager, "_captures", lambda: False)
    state, _, _ = _calls(eager, eager.init_state(), 1)
    assert _kernel_names(eager, state) <= replayed
    for kernel in ("nll_loss", "gather_rows_grad", "DeviceRadixSort"):
        assert any(kernel in n for n in replayed), kernel
