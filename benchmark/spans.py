"""The program's span tape (`gsrs_tpu_torch.utils.timer.spans`) over the
traced window, as the per-layer metrics ``host_syncs.*`` and
``host_issue_ms.*`` read it.

The program records its spans only while a `torch.profiler` profile is
active, and each profile's start clears the tape, so after the traced
window the tape holds that window's spans alone. A unit of work is a
``train.step``, an ``eval.run`` or a ``serve.request`` span; a call, the
outermost span of the program's entry point (``train.call``, ``eval.run``,
``serve.request``). ``sync.*`` spans stand where the host blocks on the
card, one a blocking read or copy. Where the program records no spans
(an older tree), or the tape's units differ in number from the window's,
there is nothing to read: None."""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional

# the window's work key → (its unit's span, its call's span)
KINDS = {"steps": ("train.step", "train.call"),
         "evals": ("eval.run", "eval.run"),
         "requests": ("serve.request", "serve.request")}


@dataclasses.dataclass
class WindowTape:
    spans: list
    units: int
    calls: list  # the calls' spans

    def is_sync(self, s) -> bool:
        return s.name.startswith("sync.")

    def syncs(self) -> int:
        return sum(self.is_sync(s) for s in self.spans)

    def issue_ns(self) -> int:
        """The calls' host time outside their syncs."""
        ids = {c.id for c in self.calls}
        blocked = sum(s.end_ns - s.start_ns for s in self.spans
                      if s.unit in ids and self.is_sync(s))
        return sum(c.end_ns - c.start_ns for c in self.calls) - blocked

    def own_ns_by_name(self) -> Dict[str, int]:
        """Each span name's own time (less its children's) summed over the
        calls' spans: the parts of the calls' host time."""
        ids = {c.id for c in self.calls}
        mine = [s for s in self.spans if s.unit in ids]
        own = {s.id: s.end_ns - s.start_ns for s in mine}
        for s in mine:
            if s.parent in own:
                own[s.parent] -= s.end_ns - s.start_ns
        out: Dict[str, int] = defaultdict(int)
        for s in mine:
            out[s.name] += own[s.id]
        return dict(out)


def window_tape(ctx) -> Optional[WindowTape]:
    try:
        from gsrs_tpu_torch.utils.timer import spans
    except ImportError:
        return None
    kind = next((k for k in KINDS if ctx.work.get(k)), None)
    if kind is None:
        return None
    unit, call = KINDS[kind]
    tape: List = spans()
    units = ctx.work["units"]
    if not units or sum(s.name == unit for s in tape) != units:
        return None
    return WindowTape(tape, units, [s for s in tape if s.name == call])
