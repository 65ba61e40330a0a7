"""A named phase timer, spans on the profiler's clock, and a profiler
context (port of `gsrs_tpu.utils.timer`, spans added).

`Timer` accumulates wall seconds and counts per name (``with
Timer.named("sample"): ...``). `profile_trace` is a `torch.profiler`
context that writes its trace (TensorBoard's profiler format, a Chrome
trace) under ``log_dir``, the CPU's activity and, where there is a card,
the device's; it does nothing for ``log_dir=None``.

`span` marks a unit of work or a phase of one (``with span("serve.request"):
...``). It records only while a `torch.profiler` profile is active (any
profile: `profile_trace`, a tool's, a benchmark's traced window); with
none, `span` returns one shared no-op object, reads no clock and
allocates nothing. A recorded span enters the profiler's own record
function under its name, so a CPU trace shows it beside the operators
and kernels, and goes onto a bounded tape in memory (the last
`TAPE_SPANS`): its name, start and end in Unix nanoseconds (the clock the
profiler stamps its events with), its parent (the innermost span open on
the same thread when it opened; autograd runs the card's backward on a
thread of its own), its unit (the id of the outermost span above it, so
every span of one request shares it), its thread and its attributes.
`spans` reads the tape; it holds what the newest profile recorded (a
profile's start clears it), until `clear_spans`.

Names in use: ``sync.*`` spans stand exactly where the host blocks on the
card (one span a blocking read or copy) and nowhere else; the kernels'
Python entries record ``k1``, ``k3`` and ``k4`` with the call's shapes as
``shape``.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

TAPE_SPANS = 1 << 20  # spans the tape keeps, the newest


class Span(NamedTuple):
    """One recorded span. ``parent`` is the id of the span it opened in,
    −1 for an outermost one; ``unit`` the id of its outermost span (its
    own id if it is one)."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int
    unit: int
    thread: int
    attrs: dict


_TAPE: deque = deque(maxlen=TAPE_SPANS)
_IDS = itertools.count()
_OPEN = threading.local()  # .stack: the thread's open spans, innermost last
# the profiler's own record function: the C one where torch has it
_RecordFunction = getattr(torch._C._profiler, "_RecordFunctionFast",
                          _profiler.record_function)


class _NoSpan:
    """What `span` returns while no profile is active."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


NO_SPAN = _NoSpan()


class _Recording:
    __slots__ = ("name", "attrs", "id", "parent", "unit", "start_ns", "_rf", "_stack")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> "_Recording":
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.id = next(_IDS)
        if stack:
            self.parent, self.unit = stack[-1].id, stack[-1].unit
        else:
            self.parent, self.unit = -1, self.id
        stack.append(self)
        self._stack = stack
        self._rf = _RecordFunction(self.name)
        self._rf.__enter__()
        self.start_ns = time.time_ns()  # read after the profiler stamps its event
        return self

    def __exit__(self, *exc) -> None:
        self._rf.__exit__(*exc)
        end = time.time_ns()
        stack = self._stack
        if stack and stack[-1] is self:
            stack.pop()
        else:  # closed out of order (a generator closed late)
            stack.remove(self)
        _TAPE.append(Span(self.id, self.name, self.start_ns, end, self.parent, self.unit,
                          threading.get_ident(), self.attrs))


def span(name: str, **attrs):
    """A context manager that records ``name`` (with ``attrs``) while a
    `torch.profiler` profile is active, and the shared no-op otherwise."""
    if not _profiler._is_profiler_enabled:
        return NO_SPAN
    return _Recording(name, attrs)


def spans() -> List[Span]:
    """The tape: the spans the newest profile recorded, in the order they
    closed."""
    return list(_TAPE)


def clear_spans() -> None:
    _TAPE.clear()


def _clear_on_profiler_start():
    """Have each profile's start clear the tape, so that it holds the
    newest profile's spans alone."""
    start = getattr(_profiler, "_run_on_profiler_start", None)
    if start is None or getattr(start, "clears_spans", False):
        return

    def run_on_profiler_start():
        clear_spans()
        start()

    run_on_profiler_start.clears_spans = True
    _profiler._run_on_profiler_start = run_on_profiler_start


_clear_on_profiler_start()


def own_ns(tape: List[Span], within: str) -> Dict[str, int]:
    """Each span name's own time (its length less its children's, on its
    thread), summed over the spans named ``within`` and those beneath them."""
    by_id = {s.id: s for s in tape}
    inside: Dict[int, bool] = {}

    def is_inside(s: Span) -> bool:
        if s.id not in inside:
            parent = by_id.get(s.parent)
            inside[s.id] = s.name == within or (parent is not None and is_inside(parent))
        return inside[s.id]

    own = {s.id: s.end_ns - s.start_ns for s in tape}
    for s in tape:
        if s.parent in own:
            own[s.parent] -= s.end_ns - s.start_ns
    out: Dict[str, int] = defaultdict(int)
    for s in tape:
        if is_inside(s):
            out[s.name] += own[s.id]
    return dict(out)


class Timer:
    """Named accumulating timer: ``with Timer.named("sample"): ...``;
    `Timer.dict()` returns the accumulated seconds, `Timer.counts()` the
    number of timed blocks, `Timer.zero()` resets both. A named block
    that runs under a profile also records as a span of its name."""

    NAMED_TAPE: Dict[str, float] = defaultdict(float)
    _COUNTS: Dict[str, int] = defaultdict(int)

    def __init__(self, name: Optional[str] = None):
        self.name = name
        self._t0 = 0.0
        self._span = NO_SPAN

    @classmethod
    def named(cls, name: str) -> "Timer":
        return cls(name)

    def __enter__(self) -> "Timer":
        if self.name is not None:
            self._span = span(self.name)
            self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        self._span = NO_SPAN
        if self.name is not None:
            Timer.NAMED_TAPE[self.name] += dt
            Timer._COUNTS[self.name] += 1
        self.elapsed = dt

    @classmethod
    def dict(cls) -> Dict[str, float]:
        return dict(cls.NAMED_TAPE)

    @classmethod
    def counts(cls) -> Dict[str, int]:
        return dict(cls._COUNTS)

    @classmethod
    def zero(cls) -> None:
        cls.NAMED_TAPE.clear()
        cls._COUNTS.clear()

    @classmethod
    def summary(cls) -> str:
        return " | ".join(
            f"{k}: {v:.3f}s/{cls._COUNTS[k]}" for k, v in sorted(cls.NAMED_TAPE.items())
        )


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """A `torch.profiler` trace of the block, written under ``log_dir``
    when the block ends (the spans recorded in it among its events); a
    no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
