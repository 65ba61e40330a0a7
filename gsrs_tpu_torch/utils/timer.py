"""A named phase timer and a profiler context (port of
`gsrs_tpu.utils.timer`).

`Timer` accumulates wall seconds and counts per name (``with
Timer.named("sample"): ...``). `profile_trace` is a `torch.profiler`
context that writes its trace (TensorBoard's profiler format, a Chrome
trace) under ``log_dir``, the CPU's activity and, where there is a card,
the device's; it does nothing for ``log_dir=None``."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class Timer:
    """Named accumulating timer: ``with Timer.named("sample"): ...``;
    `Timer.dict()` returns the accumulated seconds, `Timer.counts()` the
    number of timed blocks, `Timer.zero()` resets both."""

    NAMED_TAPE: Dict[str, float] = defaultdict(float)
    _COUNTS: Dict[str, int] = defaultdict(int)

    def __init__(self, name: Optional[str] = None):
        self.name = name
        self._t0 = 0.0

    @classmethod
    def named(cls, name: str) -> "Timer":
        return cls(name)

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self._t0
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
    when the block ends; a no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
