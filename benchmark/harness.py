"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

    python3 benchmark/run.py --workload gowalla-train --seed 7 --seconds 10 --trace 0

Everything a cell is made of is found by name: the configuration in
``configs/<config>.json`` (it names its plain reference,
``reference/<name>.py``), the traffic mix in ``traffic/<traffic>.json``
(it names its loop, ``loops/<loop>.py``, and may override sections
of the configuration), the limits of the check in
``limits/<workload>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``, or, for a metric split by the end-to-end metric
it moves (``device_idle_share.train``, ``.eval``), in the one reader of
its quantity, ``metrics/<the name up to its first dot>.py``.

A run: the inputs are made from the seed; then set-up (``setup_s``: the
program's graph, layout, model and kernels built or loaded, and the
warm-up) on the card; then the measured window of ``--seconds`` (with
``--trace 1`` a traced window instead, whose per-layer metrics the line
reports); then the peak memory is read, the program's state dropped and
the reference run for the check. The last lines on standard error, and
the ``checks`` key that ends the result line, give each number compared
beside its limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
# no module loaded by a run may have these top-level names
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gsrs_tpu")
TRACE_SECONDS = 2.0  # the traced window, at most


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def merged(cfg: dict, overrides: dict) -> dict:
    """``cfg`` with each section of ``overrides`` merged over its own."""
    out = dict(cfg)
    for section, values in overrides.items():
        out[section] = {**cfg.get(section, {}), **values}
    return out


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def loop(self):
        return importlib.import_module(f"benchmark.loops.{self.traffic['loop']}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or _json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    traffic = _json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    cfg = merged(_json(os.path.join(ROOT, conf["file"])), traffic.get("overrides", {}))
    return Cell(name, w["chips"], cfg, traffic,
                _json(os.path.join(HERE, "limits", f"{name}.json")),
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``, or where there is no such file,
    ``metrics/<name up to its first dot>.py``'s."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class TraceContext:
    """What a per-layer metric's reader reads: the cell's configuration
    and traffic, the traced window's work (``work``: its units of work,
    the steps, evals or requests, as ``units``, ...), each kernel call's
    shapes in it (``calls``), its device timeline, and the untraced window
    that ran before it (``timed``: its work, with its ``seconds``). The
    profiler slows the host, so a time a unit of work is taken from the
    untraced window, and device times from the traced one."""

    cfg: dict
    traffic: dict
    work: dict
    calls: Dict[str, list]
    timeline: object
    timed: dict

    @property
    def timed_s_per_unit(self) -> float:
        """Host seconds a unit of work in the untraced window."""
        return self.timed["seconds"] / self.timed["units"]

    @property
    def busy_s_per_unit(self) -> float:
        """Device-busy seconds a unit of work in the traced window."""
        return self.timeline.busy_s / self.work["units"]

    def kernel_s(self, names) -> float:
        from benchmark.trace import kernel_seconds

        return kernel_seconds(self.timeline, names)


def forbidden_modules() -> List[str]:
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def _traced(cell: Cell, sut, seconds: float):
    """The untraced window of ``seconds``, then the traced one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.trace import ShapeRecorder, read_profile

    timed = cell.loop.window(sut, seconds)
    rec = ShapeRecorder()
    rec.install()
    try:
        cell.loop.window(sut, 0.0)  # one call: the recorder meets every table
        rec.reset()
        # the card's activity alone: recording the host's operators too
        # slowed a host-bound step about 1.75 fold
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts = [ProfilerActivity.CUDA]
            torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            out = cell.loop.window(sut, min(seconds, TRACE_SECONDS))
            window_s = time.perf_counter() - t0
    finally:
        rec.uninstall()
    timeline = read_profile(prof, window_s)
    ctx = TraceContext(cell.cfg, cell.traffic, out["work"], rec.calls, timeline,
                       timed["work"])
    metrics, notes = {}, {}
    for m in cell.per_layer:
        got = metric_reader(m["name"])(ctx)
        if got is None:
            continue
        value, note = got if isinstance(got, tuple) else (got, None)
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if note:
            notes[m["name"]] = note
    both = dict(out, attempted=timed["attempted"] + out["attempted"],
                failed=timed["failed"] + out["failed"])
    return both, metrics, notes, timeline


def _print_calls(call_s: List[float]) -> None:
    """The window's call times on standard error, by quarter of the window:
    whether a slow run was slow throughout or in one stretch."""
    import numpy as np

    parts = np.array_split(np.asarray(call_s), 4)
    text = " | ".join(f"n {p.size} median {np.median(p):.6f} p95 {np.percentile(p, 95):.6f}"
                      for p in parts if p.size)
    print(f"window call seconds by quarter: {text}", file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """One run of ``cell`` on ``device`` → the result line's object."""
    import torch

    drv = cell.loop
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    inputs = drv.make_inputs(cell.cfg, cell.traffic, seed, device)
    inputs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    sut = drv.setup(cell.cfg, cell.traffic, inputs, seed, device)
    setup_s = time.perf_counter() - t0
    notes, timeline = {}, None
    if trace:
        out, metrics, notes, timeline = _traced(cell, sut, seconds)
    else:
        out = drv.window(sut, seconds)
        _print_calls(out["work"]["call_s"])
        measured = dict(out["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": measured[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    t0 = time.perf_counter()
    observed = drv.observe(sut)
    del sut
    if cuda:
        torch.cuda.empty_cache()
    readings = drv.check(cell.cfg, cell.traffic, inputs, seed, observed, device)
    check_s = time.perf_counter() - t0
    checks = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in readings.items()}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if cuda:
        from benchmark.counts.peaks import power_limit_w

        dev["power_limit_w"] = power_limit_w()
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    if timeline is not None:
        dev["busy_s"], dev["window_s"] = timeline.busy_s, timeline.window_s
        result["breakdown"] = {"device_ops": timeline.device_ops,
                               "idle_gaps": timeline.idle_gaps}
        result["notes"] = notes
    result.update(inputs_s=inputs_s, setup_s=setup_s, check_s=check_s)
    result["checks"] = checks
    return result


def _finite(x):
    return x if x == x and abs(x) != float("inf") else (1e300 if x == x else -1.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0")
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded forbidden modules: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        c["value"] = _finite(float(c["value"]))
    for k in ("inputs_s", "setup_s", "check_s"):
        print(f"{k} {result[k]}", file=sys.stderr)
    for name, note in result.get("notes", {}).items():
        print(f"note {name}: {note}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
