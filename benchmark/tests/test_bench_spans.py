"""The readers of the program's span tape, ``host_syncs.*`` and
``host_issue_ms.*``, on hand-built tapes: the hand-worked value, None
where the tape's units differ in number from the window's or the program
records no spans; and the tape of a tiny traced run on the CPU."""

import sys
import types

import pytest

from benchmark import harness
from benchmark.tests.conftest import tiny_cell

MS = 1_000_000  # ns


def _tape(*rows):
    """Spans from (id, name, start ms, end ms, parent id); units follow the
    parents up."""
    from gsrs_tpu_torch.utils.timer import Span

    parent = {r[0]: r[4] for r in rows}

    def unit(i):
        while parent[i] != -1:
            i = parent[i]
        return i

    return [Span(i, name, int(s * MS), int(e * MS), p, unit(i), 1, {})
            for i, name, s, e, p in rows]


TRAIN = _tape(
    (0, "train.call", 0, 10, -1),
    (1, "train.sample", 0, 1, 0),
    (2, "train.step", 1, 5, 0),
    (3, "train.forward", 1, 3, 2), (4, "propagate", 1, 2, 3),
    (5, "train.backward", 3, 4, 2), (6, "train.optimizer", 4, 4.5, 2),
    (7, "train.step", 5, 8.5, 0),
    (8, "train.forward", 5, 7, 7), (9, "train.backward", 7, 8, 7),
    (10, "train.optimizer", 8, 8.5, 7),
    (11, "sync.train.loss", 8.5, 9.5, 0),
    (12, "k4", 3.2, 3.4, -1),  # on autograd's thread: a unit of its own
)
EVAL = _tape(
    (0, "eval.run", 0, 20, -1),
    (1, "eval.propagate", 0, 2, 0),
    (2, "eval.batch", 2, 10, 0), (3, "eval.score", 2, 4, 2), (4, "eval.topk", 4, 9, 2),
    (5, "sync.topk.ties", 5, 8, 4), (6, "eval.metrics", 9, 10, 2),
    (7, "eval.batch", 10, 18, 0), (8, "eval.score", 10, 12, 7), (9, "eval.topk", 12, 17, 7),
    (10, "sync.topk.ties", 13, 16, 9), (11, "eval.metrics", 17, 18, 7),
    (12, "sync.eval.read", 18, 19.5, 0),
)
SERVE = [s for k in range(2) for s in _tape(
    (10 * k, "serve.request", 0, 0.6, -1),
    (10 * k + 1, "sync.serve.h2d", 0.0, 0.05, 10 * k),
    (10 * k + 2, "serve.score", 0.05, 0.35, 10 * k),
    (10 * k + 3, "sync.topk.ties", 0.2, 0.3, 10 * k + 2),
    (10 * k + 4, "sync.serve.fetch", 0.35, 0.45, 10 * k),
    (10 * k + 5, "sync.serve.fetch", 0.45, 0.5, 10 * k),
)]

CASES = {  # the tape, the window's work, (host_syncs, host_issue_ms)
    "train": (TRAIN, {"units": 2, "steps": 2}, (0.5, (10 - 1) / 2)),
    "eval": (EVAL, {"units": 1, "evals": 1}, (3.0, 20 - 3 - 3 - 1.5)),
    "serve": (SERVE, {"units": 2, "requests": 2}, (4.0, 0.6 - 0.05 - 0.1 - 0.1 - 0.05)),
}


def _read(metric, tape, work, monkeypatch):
    from gsrs_tpu_torch.utils import timer

    monkeypatch.setattr(timer, "spans", lambda: list(tape))
    return harness.metric_reader(metric)(types.SimpleNamespace(work=work))


@pytest.mark.parametrize("kind", sorted(CASES))
def test_readers_give_the_hand_worked_values(kind, monkeypatch):
    tape, work, (syncs, issue) = CASES[kind]
    assert _read(f"host_syncs.{kind}", tape, work, monkeypatch) == pytest.approx(syncs)
    value, note = _read(f"host_issue_ms.{kind}", tape, work, monkeypatch)
    assert value == pytest.approx(issue)
    assert note.startswith("own ms a unit: ")
    parts = dict(p.rsplit(" ", 1) for p in note[len("own ms a unit: "):].split(", "))
    # the parts of the calls' time sum to it, and leave out other units
    calls = {"train": 10 / 2, "eval": 20, "serve": 0.6}[kind]
    assert sum(map(float, parts.values())) == pytest.approx(calls, rel=1e-3)
    assert "k4" not in parts


def test_train_note_splits_the_step(monkeypatch):
    tape, work, _ = CASES["train"]
    _, note = _read("host_issue_ms.train", tape, work, monkeypatch)
    parts = dict(p.rsplit(" ", 1) for p in note[len("own ms a unit: "):].split(", "))
    assert {k: float(v) for k, v in parts.items()} == {
        "train.forward": 1.5, "train.backward": 1.0, "train.sample": 0.5, "propagate": 0.5,
        "train.optimizer": 0.5, "sync.train.loss": 0.5, "train.call": 0.25, "train.step": 0.25}
    assert list(parts)[0] == "train.forward"  # the largest first


@pytest.mark.parametrize("kind", sorted(CASES))
def test_a_unit_count_that_disagrees_reads_nothing(kind, monkeypatch):
    tape, work, _ = CASES[kind]
    work = dict(work, units=work["units"] + 1)
    for key in ("steps", "evals", "requests"):
        if key in work:
            work[key] += 1
    for metric in ("host_syncs", "host_issue_ms"):
        assert _read(f"{metric}.{kind}", tape, work, monkeypatch) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "gsrs_tpu_torch.utils.timer", None)
    work = {"units": 2, "steps": 2}
    for metric in ("host_syncs.train", "host_issue_ms.train"):
        assert harness.metric_reader(metric)(types.SimpleNamespace(work=work)) is None


def test_a_tiny_traced_run_reads_its_own_window():
    """Through the harness on the CPU: the tape holds the traced window
    alone (four syncs a request: h2d, the tie read, two copies back)."""
    r = harness.run_cell(tiny_cell("gowalla-serve"), 2**31 + 5, 0.2, True, "cpu")
    assert r["correct"]
    assert r["metrics"]["host_syncs.serve"]["value"] == 4.0
    assert r["metrics"]["host_issue_ms.serve"]["value"] > 0
    assert "serve.score" in r["notes"]["host_issue_ms.serve"]
