"""The traced run: the shapes of each hand-written kernel call, recorded
by wrappers around the kernels' Python entries, and the profiler's
device timeline reduced to kernel times, busy time and idle gaps.

The wrappers are installed only for a traced run and removed after it:
``gather_reduce`` (K4, `gsrs_tpu_torch/ops/ell_kernel.py`) and
``masked_scores`` (K1, `gsrs_tpu_torch/ops/scoring.py`) wherever a module
of the program holds them by name, and ``LeafPlan.launch`` (K3,
`gsrs_tpu_torch/train/fused_adam.py`).
"""

from __future__ import annotations

import bisect
import dataclasses
import sys
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch

PROGRAM = "gsrs_tpu_torch"
ATTRIBUTED = 2000  # the longest idle gaps named by their host operation


class ShapeRecorder:
    """Records ``calls["k1"|"k4"|"k3"]``: one tuple of shapes per call."""

    def __init__(self):
        self.calls: Dict[str, list] = {"k1": [], "k4": [], "k3": []}
        self._undo: List[Tuple[object, str, object]] = []
        self._nnz: Dict[int, int] = {}

    def reset(self) -> None:
        for v in self.calls.values():
            v.clear()

    def _replace(self, target, name: str, new) -> None:
        self._undo.append((target, name, getattr(target, name)))
        setattr(target, name, new)

    def _wrap_everywhere(self, fn, wrapper) -> None:
        """Replace ``fn`` by ``wrapper`` in every loaded module of the
        program that holds it under a name."""
        for mod_name, mod in list(sys.modules.items()):
            if mod is None or mod_name.split(".")[0] != PROGRAM:
                continue
            for name, value in list(vars(mod).items()):
                if value is fn:
                    self._replace(mod, name, wrapper)

    def install(self) -> None:
        from gsrs_tpu_torch.ops import ell_kernel, scoring
        from gsrs_tpu_torch.train import fused_adam

        k4, k1 = ell_kernel.gather_reduce, scoring.masked_scores
        launch = fused_adam.LeafPlan.launch
        calls, nnz = self.calls, self._nnz

        def gather_reduce(table, x, mask=None, out=None):
            key = id(table)
            if key not in nnz:
                nnz[key] = int(sum(int(torch.count_nonzero(w)) for _, w, _ in table.buckets))
            calls["k4"].append((nnz[key], x.shape[0], table.n_rows, x.shape[1],
                                x.element_size()))
            return k4(table, x, mask, out)

        def masked_scores(user_emb, item_emb, bitset_rows, bitplane=False, block_m=4096):
            calls["k1"].append((user_emb.shape[0], item_emb.shape[0], user_emb.shape[1],
                                bitset_rows.shape[1]))
            return k1(user_emb, item_emb, bitset_rows, bitplane, block_m)

        def leaf_launch(plan, grads, lr, c1, c2, consts):
            calls["k3"].append(tuple(
                (int(np.prod(s)), torch.empty((), dtype=dt).element_size())
                for s, dt in zip(plan.shapes, plan.dtypes)))
            return launch(plan, grads, lr, c1, c2, consts)

        self._wrap_everywhere(k4, gather_reduce)
        self._wrap_everywhere(k1, masked_scores)
        self._replace(fused_adam.LeafPlan, "launch", leaf_launch)

    def uninstall(self) -> None:
        while self._undo:
            target, name, old = self._undo.pop()
            setattr(target, name, old)


@dataclasses.dataclass
class Timeline:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]
    device_ops: List[list]
    idle_gaps: List[list]


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _host_under(t: int, host, starts, reach: int = 5000) -> str:
    """The name of the latest-started host operation still running at
    ``t`` (the innermost of a stack), looking back ``reach`` operations."""
    i = bisect.bisect_right(starts, t)
    for hs, he, name in reversed(host[max(0, i - reach):i]):
        if he >= t:
            return name
    return "host, in no CUDA call"


def read_profile(prof, window_s: float, top: int = 10) -> Timeline:
    """The device timeline of a profile taken around the traced window
    alone (it starts after a synchronize and ends with one): kernel and
    copy times by name, the busy seconds (their union), and the idle gaps
    between the first and the last event, summed by the CUDA call the host
    was in at the middle of each gap (the profiler records the CUDA
    runtime's calls on the host, and not the host's operators, whose
    recording would slow the host several fold)."""
    from torch.autograd import DeviceType

    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            host.append((start, start + dur, e.name()))
        elif not e.is_user_annotation() and dur > 0:
            device.append((start, start + dur, e.name()))
    kernel_s: Dict[str, float] = defaultdict(float)
    for s, e, n in device:
        kernel_s[n] += (e - s) * 1e-9
    busy = _union([(s, e) for s, e, _ in device])
    spans = [(s, e) for s, e, _ in host] + busy
    gaps = []
    if spans:
        t0, t1 = min(s for s, _ in spans), max(e for _, e in spans)
        last = t0
        for s, e in busy:
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        if t1 > last:
            gaps.append((last, t1))
    host.sort()
    starts = [h[0] for h in host]
    by_host: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    gaps.sort(key=lambda g: g[0] - g[1])
    for s, e in gaps[ATTRIBUTED:]:
        by_host["shorter gaps"][0] += (e - s) * 1e-9
        by_host["shorter gaps"][1] += 1
    for s, e in gaps[:ATTRIBUTED]:
        acc = by_host[_host_under((s + e) // 2, host, starts)]
        acc[0] += (e - s) * 1e-9
        acc[1] += 1
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1][0])[:top]
    return Timeline(
        window_s=window_s,
        busy_s=sum(e - s for s, e in busy) * 1e-9,
        kernel_s=dict(kernel_s),
        device_ops=[[n, t] for n, t in ops],
        idle_gaps=[[f"{n} ({c} gaps)", t] for n, (t, c) in idle],
    )


def kernel_seconds(timeline: Timeline, names) -> float:
    """Device seconds of the kernels whose profiler name contains any of
    ``names``."""
    return sum(t for k, t in timeline.kernel_s.items() if any(n in k for n in names))
