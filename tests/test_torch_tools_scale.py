"""The port's scale tools (`gsrs_tpu_torch.tools`: bench_scaling,
sweep_xsimgcl, profile_epoch, bench_scale_standin) against the JAX
package's (``tools/``) on the CPU at tiny sizes: the port with ``--device
cpu`` (its mesh sizes as gloo CPU ranks), JAX on the 8-device CPU mesh.
JAX's parameters come from ``jax.random`` and the port's from a torch
generator, so the two print the same structure, not the same losses.

- bench_scaling: the same ``devices``/``mesh`` rows with JAX's keys (the
  port's added keys aside) and the same skip line; the port's warm-up
  losses equal across mesh sizes within MESH_LOSS_RTOL.
- sweep_xsimgcl: the same grid, eval epochs and line format; each
  configuration's checkpoint directory named as JAX names it.
- profile_epoch: the same `Timer` phase names and counts; the port's trace
  file is written.
- bench_scale_standin: `SHAPES` equal to JAX's; the held-out stand-in
  equal array for array to the JAX tool's construction; a ``--single``
  row with JAX's keys at a tiny shape; `drive` exits non-zero when a
  config's subprocess fails.
- quality_bench: `summarize` reads the port's ``valid_epoch_metrics.csv``,
  whose header equals the JAX trainer's.
"""

import contextlib
import csv
import dataclasses
import importlib.util
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest

from gsrs_tpu_torch.data import synthetic as tsyn
from gsrs_tpu_torch.data.dataset import write_interaction_file
from gsrs_tpu_torch.tools import bench_scale_standin, bench_scaling, profile_epoch, sweep_xsimgcl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
MESH_LOSS_RTOL = 1e-4  # chip_smoke.py's MESH_BLOCK_LIMITS["bf16"]["loss_rtol"]
PORT_ONLY_KEYS = {"launches"}
TINY_SHAPE = dict(n_users=90, m_items=70, avg_degree=6)


@pytest.fixture
def jax():
    return pytest.importorskip("jax", reason="the JAX package is the reference")


def _dataset_dir(root, name="tiny"):
    d = tsyn.clustered(120, 160, seed=3)
    path = os.path.join(root, name)
    os.makedirs(path)
    write_interaction_file(os.path.join(path, "train.txt"), d.train_users, d.train_items)
    tu = np.concatenate([np.full(len(v), k) for k, v in d.test_dict.items()])
    write_interaction_file(os.path.join(path, "test.txt"), tu,
                           np.concatenate(list(d.test_dict.values())))
    return path


def _jax_tool(name):
    """The JAX package's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax_main(monkeypatch, module, argv, fn="main"):
    """The JAX tool's ``main()`` (it reads sys.argv) → (its return, its
    standard output)."""
    monkeypatch.setattr(sys, "argv", [module.__file__] + list(argv))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = getattr(module, fn)()
    return out, buf.getvalue()


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(argv)
    return out, buf.getvalue()


def _json_rows(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _skips(text):
    return [ln for ln in text.splitlines() if ln.startswith("# skipping")]


# -------------------------------------------------------------- bench_scaling


def test_bench_scaling_rows_and_skips_match_jax(monkeypatch, jax):
    argv = ["--n_users", "200", "--m_items", "150", "--batch", "64", "--steps", "1",
            "--devices", "1", "2", "4", "5", "--dim", "16", "--layers", "1"]
    rows, text = _run(bench_scaling.main, argv + ["--device", CPU])
    want, jtext = _run_jax_main(monkeypatch, _jax_tool("bench_scaling"), argv)
    assert _json_rows(text) == rows
    assert [(r["devices"], r["mesh"]) for r in rows] == [(r["devices"], r["mesh"]) for r in want]
    assert [(r["devices"], r["mesh"]) for r in rows] == [(1, "1x1"), (2, "2x1"), (4, "2x2")]
    assert _skips(text) == _skips(jtext) == [
        "# skipping 5 devices (not divisible by model_axis=2)"]
    extra = {"backend", "ranks_per_card", "warmup_loss"} | PORT_ONLY_KEYS
    for got, ref in zip(rows, want):
        assert set(got) == set(ref) | extra
        assert got["examples_per_s"] > 0 and got["scaling_efficiency"] > 0
    assert [r["backend"] for r in rows] == [None, "gloo", "gloo"]
    losses = np.array([r["warmup_loss"] for r in rows])
    assert np.isfinite(losses).all() and 0.5 < losses[0] < 0.8  # about ln 2 at the start
    np.testing.assert_allclose(losses, losses[0], rtol=MESH_LOSS_RTOL)


def test_bench_scaling_mesh_axes_are_jaxs():
    assert [bench_scaling.mesh_axes(n)[0] for n in (1, 2, 3, 4, 6, 8)] == [
        (1, 1), (2, 1), (3, 1), (2, 2), (3, 2), (4, 2)]
    assert bench_scaling.mesh_axes(5) == (
        None, "# skipping 5 devices (not divisible by model_axis=2)")


# -------------------------------------------------------------- sweep_xsimgcl


def _sweep_lines(text):
    """Headers, and each eval line reduced to its epoch and key order."""
    out = []
    for ln in text.splitlines():
        if ln.startswith("==="):
            out.append(ln)
        elif ln.startswith("  e"):
            epoch, loss, *metrics = ln.split()
            assert loss.startswith("loss=") and len(loss.split("=")[1].split(".")[1]) == 4
            assert all(len(m.split("=")[1].split(".")[1]) == 5 for m in metrics)
            out.append((epoch, [m.split("=")[0] for m in metrics]))
        elif ln.startswith("  ("):
            assert ln.endswith("s)")
            out.append("time")
    return out


def test_sweep_xsimgcl_prints_jaxs_grid_and_lines(tmp_path, monkeypatch, jax):
    from gsrs_tpu.train import trainer as jtrainer

    _dataset_dir(tmp_path)
    argv = ["--data_root", str(tmp_path), "--dataset", "tiny", "--epochs", "3", "--eval_every",
            "2", "--lambdas", "0.1", "0.2", "--batch", "256", "--recdim", "16", "--layer", "2"]
    ckpt_root = tmp_path / "ckpt"
    traj, text = _run(sweep_xsimgcl.main, argv + ["--checkpoint_root", str(ckpt_root),
                                                  "--device", CPU])
    # the JAX trainer makes its checkpoint directory at construction: keep it in tmp_path
    named = []
    real = jtrainer.CheckpointManager

    def manager(path):
        named.append(os.path.basename(path))
        return real(str(tmp_path / "jax" / os.path.basename(path)))

    monkeypatch.setattr(jtrainer, "CheckpointManager", manager)
    _, jtext = _run_jax_main(monkeypatch, _jax_tool("sweep_xsimgcl"), argv)
    assert _sweep_lines(text) == _sweep_lines(jtext)
    assert [ln for ln in _sweep_lines(text) if isinstance(ln, str) and ln != "time"] == [
        "=== cl_lambda=0.1 cl_eps=0.2 ===", "=== cl_lambda=0.2 cl_eps=0.2 ==="]
    assert named == ["sweep_l0.1_e0.2", "sweep_l0.2_e0.2"]
    assert not ckpt_root.exists()  # the sweep saves nothing
    assert sorted(traj) == [(0.1, 0.2), (0.2, 0.2)]
    for rows in traj.values():
        assert [r["epoch"] for r in rows] == [2, 3]
        assert all(np.isfinite(r["loss"]) and 0 <= r["recall@20"] <= 1 for r in rows)


def test_sweep_xsimgcl_uses_the_stand_in_without_train_txt(tmp_path, monkeypatch):
    from gsrs_tpu_torch import bench

    small = tsyn.powerlaw(60, 50, avg_degree=5, seed=1, holdout_frac=0.2)
    monkeypatch.setattr(bench, "stand_in_data", lambda: small)
    traj, text = _run(sweep_xsimgcl.main, ["--data_root", str(tmp_path), "--dataset", "none",
                                           "--epochs", "1", "--eval_every", "1", "--lambdas",
                                           "0.1", "--batch", "128", "--recdim", "8", "--device",
                                           CPU])
    assert "has no train.txt" in text and list(traj) == [(0.1, 0.2)]


# -------------------------------------------------------------- profile_epoch


def _phases(summary):
    """{phase: count} of a `Timer.summary()`."""
    return {part.split(": ")[0]: part.rsplit("/", 1)[1] for part in summary.split(" | ")}


@pytest.mark.parametrize("evaluate", [False, True])
def test_profile_epoch_phases_match_jax(tmp_path, monkeypatch, jax, evaluate):
    from gsrs_tpu.utils.timer import Timer as JaxTimer

    _dataset_dir(tmp_path)
    argv = ["--data_root", str(tmp_path), "--dataset", "tiny", "--epochs", "2",
            "--bpr_batch", "256", "--recdim", "16"] + (["--eval"] if evaluate else [])
    trace = tmp_path / "trace"
    summary, text = _run(profile_epoch.main, argv + ["--trace_dir", str(trace),
                                                     "--device", CPU])
    JaxTimer.zero()
    _, jtext = _run_jax_main(monkeypatch, _jax_tool("profile_epoch"), argv)
    want = _phases(JaxTimer.summary())
    assert _phases(summary) == want
    assert set(want) == {"load_data", "init", "warmup_epoch_incl_compile", "epoch"} | (
        {"warmup_eval_incl_compile", "eval"} if evaluate else set())
    assert want["epoch"] == "2"
    assert summary in text and f"trace written to {trace}" in text
    traces = [f for f in os.listdir(trace) if f.endswith(".json")]
    assert len(traces) == 1
    with open(trace / traces[0]) as f:
        assert json.load(f)["traceEvents"]


# -------------------------------------------------------- bench_scale_standin


def test_scale_standin_shapes_are_jaxs(jax):
    assert bench_scale_standin.SHAPES == _jax_tool("bench_scale_standin").SHAPES


def test_held_out_standin_is_the_jax_tools_construction(jax):
    """The JAX tool builds it inline: big_synthetic(seed=0) from its
    tools/stress_pod.py, then 10 items a user from default_rng(1)."""
    jsp = _jax_tool("stress_pod")
    want = jsp.big_synthetic(seed=0, **TINY_SHAPE)
    rng = np.random.default_rng(1)
    td = {int(u): rng.integers(0, want.m_items, 10) for u in range(want.n_users)}
    got = bench_scale_standin.held_out_standin(**TINY_SHAPE)
    assert (got.n_users, got.m_items) == (want.n_users, want.m_items)
    np.testing.assert_array_equal(got.train_users, want.train_users)
    np.testing.assert_array_equal(got.train_items, want.train_items)
    assert sorted(got.test_dict) == sorted(td)
    for u in td:
        np.testing.assert_array_equal(got.test_dict[u], td[u])


def test_scale_standin_single_row_has_jaxs_keys(monkeypatch, jax):
    argv = ["--single", "--shapes", "tiny", "--spmm", "ell", "--batch", "128",
            "--timed_epochs", "1"]
    monkeypatch.setitem(bench_scale_standin.SHAPES, "tiny", TINY_SHAPE)
    rows, text = _run(bench_scale_standin.main, argv + ["--device", CPU])
    jtool = _jax_tool("bench_scale_standin")
    monkeypatch.setitem(jtool.SHAPES, "tiny", TINY_SHAPE)
    _, jtext = _run_jax_main(monkeypatch, jtool, argv)
    (want,) = _json_rows(jtext)
    assert _json_rows(text) == rows and len(rows) == 1
    (row,) = rows
    assert set(row) == set(want) | {"params_bytes", "layout_bytes"} | PORT_ONLY_KEYS
    for key in ("shape", "spmm", "batch", "edges"):
        assert row[key] == want[key]
    assert row["hbm_gib_in_use"] is None  # the CPU; a card's reading otherwise
    assert row["train_epoch_s"] > 0 and row["eval_users_per_s"] > 0
    assert row["params_bytes"] > 0 and row["layout_bytes"] > 0


def test_scale_standin_hybrid_row(monkeypatch):
    monkeypatch.setitem(bench_scale_standin.SHAPES, "tiny", TINY_SHAPE)
    rows, _ = _run(bench_scale_standin.main, ["--single", "--shapes", "tiny", "--spmm", "hybrid",
                                              "--batch", "128", "--timed_epochs", "1",
                                              "--hybrid_cols", "16", "--device", CPU])
    assert [(r["spmm"], r["batch"]) for r in rows] == [("hybrid", 128)]


def test_scale_standin_drive_fails_on_a_failed_config(capsys):
    with pytest.raises(SystemExit) as exc:
        bench_scale_standin.drive(["--shapes", "no-such-shape", "--spmm", "ell", "--batch", "64",
                                   "--timeout", "120", "--device", CPU])
    assert exc.value.code not in (0, None)
    (row,) = _json_rows(capsys.readouterr().out)
    assert row == {"shape": "no-such-shape", "spmm": "ell", "batch": 64, "attempt": 1,
                   "result": "FAILED"}


def test_tensor_bytes_walks_layouts():
    import torch

    from gsrs_tpu_torch.ops.ell import ell_from_interactions

    data = tsyn.powerlaw(40, 30, avg_degree=4, seed=0)
    ell = ell_from_interactions(data)
    leaves = []

    def walk(obj):
        if isinstance(obj, torch.Tensor):
            leaves.append(obj)
        elif dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                walk(getattr(obj, f.name))
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                walk(v)

    walk(ell)
    assert leaves and bench_scale_standin.tensor_bytes(ell) == sum(
        t.numel() * t.element_size() for t in leaves)


# --------------------------------------------------------------- quality_bench


def test_quality_bench_reads_the_ports_valid_csv(tmp_path, jax):
    from gsrs_tpu.train.logging import make_valid_csv as jax_valid_csv

    from gsrs_tpu_torch import cli

    ds = _dataset_dir(tmp_path)
    ckpt = tmp_path / "ckpt"
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["--data_root", str(tmp_path), "--dataset", os.path.basename(ds), "--epochs",
                  "2", "--eval_every", "1", "--recdim", "8", "--layer", "1", "--bpr_batch",
                  "256", "--topks", "[10,20]", "--checkpoint_dir", str(ckpt)], device=CPU)
    jax_valid_csv(str(tmp_path / "jax"), (10, 20))
    with open(ckpt / "valid_epoch_metrics.csv") as f, \
            open(tmp_path / "jax" / "valid_epoch_metrics.csv") as g:
        assert next(csv.reader(f)) == next(csv.reader(g))
    results = tmp_path / "results"
    results.mkdir()
    shutil.copy(ckpt / "valid_epoch_metrics.csv", results / "port-valid.csv")
    spec = importlib.util.spec_from_file_location("quality_bench",
                                                  os.path.join(ROOT, "quality_bench.py"))
    qb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qb)
    s = qb.summarize(str(results / "port-valid.csv"))
    with open(ckpt / "valid_epoch_metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert s["run"] == "port" and s["evals"] == len(rows) == 3  # epochs 0, 1 and 2
    assert s["last_epoch"] == 2
    for metric in ("recall@20", "ndcg@20", "precision@20"):
        best = max((float(r[metric]), int(r["epoch"])) for r in rows)
        assert s["best"][metric] == {"value": best[0], "epoch": best[1]}
