"""The port's spans (`gsrs_tpu_torch.utils.timer.span`): nothing recorded
and nothing allocated without a profile; under one, parents and units by
thread, the profiler's own clock, and the spans that training, the eval
and a request record on the CPU. Marked ``gpu`` (run on the card): every
host–device sync of a unit of each loop stands in a ``sync.*`` span (the
count of `torch.cuda.set_sync_debug_mode`'s warnings), each such span ends
as the card's work it waited for ends, and the kernels' spans carry their
calls' shapes."""

import itertools
import threading
import time
import tracemalloc
import warnings
from collections import Counter

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from gsrs_tpu_torch import config as tcfg
from gsrs_tpu_torch.data import adjacency as tadj
from gsrs_tpu_torch.data import synthetic as tsyn
from gsrs_tpu_torch.models.registry import build_model
from gsrs_tpu_torch.ops.bitset import build_bitset
from gsrs_tpu_torch.ops.topk import topk_threshold
from gsrs_tpu_torch.serve import Retriever
from gsrs_tpu_torch.train.trainer import Trainer
from gsrs_tpu_torch.utils import timer
from gsrs_tpu_torch.utils.timer import NO_SPAN, Timer, clear_spans, span, spans

CPU = "cpu"


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def by_id(tape):
    return {s.id: s for s in tape}


def children(tape, parent):
    return [s for s in tape if s.parent == parent.id]


# ------------------------------------------------------------------ the span


def _allocated(fn):
    """(bytes held after ``fn``, its peak) over what was held before, as
    tracemalloc sees them; after warm-up calls that fill the free lists."""
    for _ in range(3):
        fn()
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        fn()
        current, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    return current - before, peak - before


def test_without_a_profile_a_span_is_the_shared_no_op(monkeypatch):
    clear_spans()

    def no_clock():
        raise AssertionError("a span read the clock with no profile active")

    monkeypatch.setattr(timer.time, "time_ns", no_clock)
    assert span("a") is NO_SPAN and span("b", shape=(1, 2)) is NO_SPAN

    def calls():
        for _ in itertools.repeat(None, 1000):  # no int objects either
            span("serve.request")

    def blocks(ctx=None):
        for _ in itertools.repeat(None, 1000):
            with ctx or span("serve.request"):
                pass

    def bare():
        for _ in itertools.repeat(None, 1000):
            pass

    # the memory held, and the peak, over each loop: the `with` statement
    # itself takes a block of the interpreter's, with a span or without
    assert _allocated(calls) == _allocated(bare)
    assert _allocated(blocks) == _allocated(lambda: blocks(NO_SPAN))
    assert spans() == []


def test_spans_nest_by_thread_and_share_their_unit():
    other = []

    def on_another_thread():
        with span("thread.work") as s:
            other.append(s)

    with cpu_profile():
        with span("outer", shape=(3, 4)):
            with span("inner"):
                with span("innermost"):
                    t = threading.Thread(target=on_another_thread)
                    t.start()
                    t.join(timeout=30)
            with Timer.named("timed"):
                pass
        with span("next"):
            pass
    assert not t.is_alive() and other
    tape = spans()
    names = {s.name: s for s in tape}
    assert set(names) == {"outer", "inner", "innermost", "thread.work", "timed", "next"}
    outer = names["outer"]
    assert outer.parent == -1 and outer.unit == outer.id and outer.attrs == {"shape": (3, 4)}
    assert names["inner"].parent == outer.id and names["timed"].parent == outer.id
    assert names["innermost"].parent == names["inner"].id
    assert {names[n].unit for n in ("inner", "innermost", "timed")} == {outer.id}
    # autograd's card thread opens its spans with no parent: a unit of its own
    th = names["thread.work"]
    assert th.parent == -1 and th.unit == th.id and th.thread != outer.thread
    assert names["next"].parent == -1 and names["next"].unit == names["next"].id
    for s in tape:
        assert s.start_ns <= s.end_ns
        if s.parent != -1:
            p = by_id(tape)[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_a_profile_starts_a_new_tape():
    with cpu_profile():
        with span("first"):
            pass
    with span("between"):  # no profile: not recorded
        pass
    with cpu_profile():
        with span("second"):
            pass
    assert [s.name for s in spans()] == ["second"]
    clear_spans()
    assert spans() == []


def test_own_time_sums_to_the_calls_beneath_a_name():
    from gsrs_tpu_torch.utils.timer import Span, own_ns

    ms = 1_000_000
    tape = [Span(0, "train.call", 0, 10 * ms, -1, 0, 1, {}),
            Span(1, "train.step", 1 * ms, 6 * ms, 0, 0, 1, {}),
            Span(2, "train.backward", 2 * ms, 5 * ms, 1, 0, 1, {}),
            Span(3, "sync.train.loss", 7 * ms, 8 * ms, 0, 0, 1, {}),
            Span(4, "eval.run", 11 * ms, 20 * ms, -1, 4, 1, {})]
    assert own_ns(tape, "train.call") == {"train.call": 4 * ms, "train.step": 2 * ms,
                                          "train.backward": 3 * ms, "sync.train.loss": 1 * ms}
    assert own_ns(tape, "train.step") == {"train.step": 2 * ms, "train.backward": 3 * ms}
    assert own_ns(tape, "eval.run") == {"eval.run": 9 * ms}


def test_spans_are_on_the_profilers_clock():
    """Each span's start and end against its own event in the profile (the
    profiler's record function, entered by the span): within 50 µs. A
    preemption between the profiler's stamp and the span's can part one
    pair on a loaded host, so the measurement gets three tries."""
    for _ in range(3):
        with cpu_profile() as prof:
            for i in range(8):
                with span(f"clock.{i}"):
                    torch.ones(64, 64).sum()
        events = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("clock.")}
        gaps = [max(abs(s.start_ns - events[s.name][0]), abs(s.end_ns - events[s.name][1]))
                for s in spans()]
        assert len(gaps) == 8
        if max(gaps) <= 50_000:
            return
    pytest.fail(f"a span and its profiler event differ by {max(gaps) / 1e3:.1f} µs")


# ------------------------------------------------------------- the loops


def _trainer(device, spmm_mode="ell", fused_adam="off", topk_method="exact"):
    data = tsyn.clustered(60, 80, seed=3)
    cfg = tcfg.ExperimentConfig(
        model=tcfg.ModelConfig(num_layers=2, embedding_dim=8, spmm_mode=spmm_mode,
                               tiled_groups=4, tiled_cols=16),
        train=tcfg.TrainConfig(batch_size=64, lr=1e-2, steps_per_scan=3,
                               fused_adam=fused_adam),
        eval=tcfg.EvalConfig(test_batch=16, topks=(20,), topk_method=topk_method))
    graph = tadj.build_graph(data, edge_pad_multiple=256)
    return Trainer(cfg, data, graph, build_model(cfg.model, graph, device=device),
                   device=device)


def _retriever(device):
    data = tsyn.clustered(60, 80, seed=3)
    g = torch.Generator().manual_seed(0)
    seen = build_bitset(data.train_users, data.train_items, data.n_users, data.m_items)
    return Retriever(torch.randn(data.n_users, 8, generator=g),
                     torch.randn(data.m_items, 8, generator=g), seen, device=device)


def test_train_epoch_records_its_steps_and_one_loss_read():
    tr = _trainer(CPU)
    state = tr.init_state()
    with cpu_profile():
        tr.train_epoch(state)
    tape = spans()
    count = Counter(s.name for s in tape)
    steps, chunks = tr.steps_per_epoch, -(-tr.steps_per_epoch // 3)
    assert count["train.call"] == 1 and count["sync.train.loss"] == 1
    assert count["train.step"] == steps and count["train.sample"] == chunks
    assert count["train.forward"] == count["train.backward"] == steps
    assert count["train.optimizer"] == steps and count["propagate"] == steps
    call = next(s for s in tape if s.name == "train.call")
    for step in (s for s in tape if s.name == "train.step"):
        assert step.parent == call.id and step.unit == call.id
        assert [c.name for c in sorted(children(tape, step), key=lambda c: c.start_ns)] == [
            "train.forward", "train.backward", "train.optimizer"]
    ids = by_id(tape)
    assert all(ids[s.parent].name == "train.forward" for s in tape if s.name == "propagate")
    assert [s.name for s in tape if s.name.startswith("sync.")] == ["sync.train.loss"]


@pytest.mark.parametrize("method", ["exact", "threshold"])
def test_an_eval_records_its_batches_and_reads(method):
    tr = _trainer(CPU, topk_method=method)
    ev = tr.evaluator
    n_batches = ev._users.shape[0]
    with cpu_profile():
        ev.run()
    tape = spans()
    count = Counter(s.name for s in tape)
    assert count["eval.run"] == count["eval.propagate"] == count["sync.eval.read"] == 1
    for name in ("eval.batch", "eval.score", "eval.topk", "eval.metrics"):
        assert count[name] == n_batches, name
    # threshold's one flag a call is read only past 1,024 items (80 here)
    assert count["sync.topk.ties"] == (n_batches if method == "exact" else 0)
    run = next(s for s in tape if s.name == "eval.run")
    assert all(s.unit == run.id for s in tape)
    ids = by_id(tape)
    for batch in (s for s in tape if s.name == "eval.batch"):
        assert batch.parent == run.id
        assert sorted(c.name for c in children(tape, batch)) == [
            "eval.metrics", "eval.score", "eval.topk"]
    assert all(ids[s.parent].name == "eval.topk" for s in tape if s.name == "sync.topk.ties")
    assert ids[next(s for s in tape if s.name == "sync.eval.read").parent] is run


def test_threshold_topk_reads_one_flag_a_call():
    scores = torch.randn(4, 3000, generator=torch.Generator().manual_seed(1))
    with cpu_profile():
        topk_threshold(scores, 20)
    assert [s.name for s in spans()] == ["sync.topk.threshold"]


def test_a_request_holds_its_syncs():
    r = _retriever(CPU)
    with cpu_profile():
        r.recommend([5], 20)
    tape = spans()
    (req,) = [s for s in tape if s.name == "serve.request"]
    assert all(s.unit == req.id for s in tape)
    assert sorted(c.name for c in children(tape, req)) == [
        "serve.score", "sync.serve.fetch", "sync.serve.fetch", "sync.serve.h2d"]
    syncs = sorted(s.name for s in tape if s.name.startswith("sync."))
    assert syncs == ["sync.serve.fetch", "sync.serve.fetch", "sync.serve.h2d", "sync.topk.ties"]
    score = next(s for s in tape if s.name == "serve.score")
    assert by_id(tape)[next(s for s in tape if s.name == "sync.topk.ties").parent] is score


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the syncs and kernels are the card's")
    return torch.device("cuda:0")


def _units(device):
    """name → (warm-up, one unit of work) of each loop on ``device``."""
    tiled = _trainer(device, spmm_mode="tiled")
    ell = _trainer(device, fused_adam="pallas")
    r = _retriever(device)
    states = {"tiled": tiled.init_state(), "ell": ell.init_state()}

    def train(name, tr):
        def unit():
            states[name], _ = tr.train_epoch(states[name])
        return unit

    return {"train.tiled": train("tiled", tiled), "train.ell": train("ell", ell),
            "eval": lambda: ell.evaluator.run(), "serve": lambda: r.recommend([5], 20)}


def _syncs_warned(unit) -> int:
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            unit()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


@pytest.mark.gpu
def test_every_sync_on_the_card_stands_in_a_sync_span(cuda):
    for name, unit in _units(cuda).items():
        unit()  # set-up's reads (the kernels' tables) fall in the first call
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]):
            warned = _syncs_warned(unit)
        syncs = [s for s in spans() if s.name.startswith("sync.")]
        assert warned == len(syncs) > 0, (name, warned, [s.name for s in syncs])


@pytest.mark.gpu
def test_a_sync_span_ends_as_the_cards_work_before_it_ends(cuda):
    """Host clock against the device timeline: the last device event that
    started before a sync span ended is the work it waited for; the span
    ends no earlier than 20 µs before that event's end and within 1 ms
    after it. The profile holds two units and the second one's spans are
    judged, so that none stands at the profile's very start."""
    for name, unit in _units(cuda).items():
        unit()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            unit()
            mark = time.time_ns()
            unit()
        device = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                        for e in prof.profiler.kineto_results.events()
                        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation())
        starts = np.array([s for s, _, _ in device])
        syncs = [s for s in spans() if s.name.startswith("sync.") and s.start_ns > mark]
        assert syncs, name
        for s in syncs:
            i = int(np.searchsorted(starts, s.end_ns)) - 1
            assert i >= 0, (name, s.name)
            lag = s.end_ns - device[i][1]
            assert -20_000 <= lag <= 1_000_000, (name, s.name, lag, device[i][2])


@pytest.mark.gpu
def test_kernel_spans_carry_their_calls_shapes(cuda):
    tr = _trainer(cuda, fused_adam="pallas")
    state = tr.init_state()
    state, _ = tr.train_epoch(state)
    r = _retriever(cuda)
    r.recommend([5], 20)
    with profile(activities=[ProfilerActivity.CUDA]):
        tr.train_epoch(state)
        r.recommend([5], 20)
    count = Counter(s.name for s in spans())
    # K4: the same calls every step; K3: one a step; K1: one a request
    assert count["k4"] and count["k4"] % tr.steps_per_epoch == 0
    assert count["k3"] == tr.steps_per_epoch and count["k1"] == 1
    leaves = tuple((p.numel(), 4) for p in (tr.model.user_emb, tr.model.item_emb))
    tables = {id(side.table): side.table for side in (tr.model.ell.by_user, tr.model.ell.by_item)}
    nnz = {t.nnz for t in tables.values()}
    assert nnz == {int(sum(int(torch.count_nonzero(w)) for _, w, _ in t.buckets))
                   for t in tables.values()}
    for s in spans():
        if s.name == "k4":
            total, S, n_rows, d, itemsize = s.attrs["shape"]
            assert total in nnz and d == 8 and itemsize == 4
        elif s.name == "k3":
            assert s.attrs["shape"] == leaves
        elif s.name == "k1":
            assert s.attrs["shape"] == (1, r.m_items, 8, -(-r.m_items // 32))
