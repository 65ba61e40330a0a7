"""The port's bench tools (`gsrs_tpu_torch.tools`: bench_serving,
bench_eval, bench_spmm_modes, bench_seq) on the CPU at tiny sizes, and
the tools package's imports and device default.

- bench_eval: `bench_dataset` on the same parameters as the JAX tool's
  (`convert.params_from_jax`): the ``exact`` row's recall@20 and ndcg@20
  within 1e-6 of JAX's; every variant's row; a ``--checkpoint_dir`` with
  no checkpoint raises.
- Each tool runs end to end (``--device cpu``) and prints the JAX tool's
  keys, plus the kernels' launches (none on the CPU, where the plain
  versions run).
- Every tool but compute_ppr raises without a card unless ``--device cpu``
  is given; the package imports nothing of JAX.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gsrs_tpu_torch.data import synthetic as tsyn
from gsrs_tpu_torch.data.dataset import write_interaction_file
from gsrs_tpu_torch.tools import bench_eval, bench_seq, bench_serving, bench_spmm_modes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
METRIC_ATOL = 1e-6
KERNELS = {"masked_scores", "masked_scores_bitplane", "ell_gather_reduce", "fused_adam",
           "exact_topk", "exact_topk_plain", "gather_rows_grad", "gather_rows_grad_plain"}
TOOLS = ("eval_checkpoint", "bench_serving", "bench_eval", "visualize", "compute_ppr",
         "bench_spmm_modes", "bench_seq", "bench_scaling", "sweep_xsimgcl", "profile_epoch",
         "bench_scale_standin", "bench_seq_markov")


def _dataset_dir(root, name="tiny"):
    d = tsyn.clustered(120, 160, seed=3)
    path = os.path.join(root, name)
    os.makedirs(path)
    write_interaction_file(os.path.join(path, "train.txt"), d.train_users, d.train_items)
    tu = np.concatenate([np.full(len(v), k) for k, v in d.test_dict.items()])
    write_interaction_file(os.path.join(path, "test.txt"), tu,
                           np.concatenate(list(d.test_dict.values())))
    return path


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(argv)
    return out, buf.getvalue()


def _json_rows(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


# ------------------------------------------------------------------ bench_eval


@pytest.mark.parametrize("bf16", [False, True])
def test_bench_dataset_exact_row_matches_jax(tmp_path, bf16):
    jax = pytest.importorskip("jax", reason="the JAX package is the reference")
    import importlib.util

    from gsrs_tpu.config import ModelConfig as JModel
    from gsrs_tpu.data.adjacency import build_graph as jgraph
    from gsrs_tpu.data.dataset import load_dataset as jload
    from gsrs_tpu.models.registry import build_model as jbuild
    from gsrs_tpu.ops.ell import ell_from_interactions as jell

    from gsrs_tpu_torch.config import ModelConfig
    from gsrs_tpu_torch.convert import params_from_jax
    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.data.dataset import load_dataset
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.ops.ell import ell_from_interactions

    spec = importlib.util.spec_from_file_location("jax_tool_bench_eval",
                                                  os.path.join(ROOT, "tools", "bench_eval.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    ds = _dataset_dir(tmp_path)
    kw = dict(num_layers=2, embedding_dim=16, bf16_compute=bf16)
    jdata, data = jload(ds), load_dataset(ds)
    jm = jbuild(JModel(**kw), jgraph(jdata), ell=jell(jdata))
    params = jm.init_params(jax.random.key(3))
    model = build_model(ModelConfig(**kw), build_graph(data), ell=ell_from_interactions(data),
                        device=CPU)
    state = params_from_jax({k: np.asarray(v) for k, v in params.items()}, ModelConfig(**kw), CPU)
    exact = [("exact", dict(topk_method="exact", use_pallas_scoring="off"))]
    want, _ = _run(lambda a: jtool.bench_dataset("tiny", jdata, jm, params, exact, 64), None)
    got, text = _run(lambda a: bench_eval.bench_dataset("tiny", data, model, state, exact, 64),
                     None)
    (w,), (g,) = want, got
    for key in ("recall@20", "ndcg@20"):
        assert abs(g[key] - w[key]) <= METRIC_ATOL, (key, g[key], w[key])
    assert g["recall@20"] > 0
    assert set(w) <= set(g) and g["launches"] == {"masked_scores": 0,
                                                  "masked_scores_bitplane": 0}
    assert _json_rows(text) == got


def test_bench_eval_runs_every_variant_and_refuses_a_missing_checkpoint(tmp_path):
    ds = _dataset_dir(tmp_path)
    rows, text = _run(bench_eval.main, ["--dataset_dir", ds, "--skip_scale", "--test_batch",
                                        "64", "--device", CPU])
    assert [r["variant"] for r in rows] == ["auto", "exact", "approx", "pallas-bitplane+exact",
                                           "pallas-natural+exact"]
    jax_keys = {"dataset", "variant", "eval_sec", "eval_users_per_s_per_chip", "recall@20",
                "ndcg@20"}
    for r in rows:
        assert set(r) == jax_keys | {"launches"} and r["dataset"] == "gowalla"
        assert r["eval_sec"] > 0 and 0 <= r["recall@20"] <= 1
    exact = {r["variant"]: (r["recall@20"], r["ndcg@20"]) for r in rows}
    # the bit-plane layout and the natural one score the same
    assert exact["pallas-bitplane+exact"] == exact["exact"] == exact["auto"]
    assert "== summary ==" in text and "RANDOM" in text
    with pytest.raises(SystemExit, match="NO checkpoint"):
        _run(bench_eval.main, ["--dataset_dir", ds, "--skip_scale", "--checkpoint_dir",
                               str(tmp_path / "none"), "--device", CPU])


def test_amazon_scale_standin_is_the_jax_tools():
    sdata = bench_eval.amazon_scale_standin()
    assert (sdata.n_users, sdata.m_items, sdata.train_size) == (52643, 91599, 52643 * 57)
    assert len(sdata.test_dict) == 52643
    rng = np.random.default_rng(1)
    for u in range(3):  # the JAX tool draws them so, user after user
        np.testing.assert_array_equal(sdata.test_dict[u], rng.integers(0, 91599, 10))


# ------------------------------------------------------------- bench_serving


def test_bench_serving_prints_the_jax_keys(tmp_path):
    from gsrs_tpu_torch import cli

    ds = _dataset_dir(tmp_path)
    ck = str(tmp_path / "ck")
    with contextlib.redirect_stdout(io.StringIO()):
        tr, _ = cli.main(["--data_root", str(tmp_path), "--dataset", "tiny", "--layer", "2",
                          "--recdim", "16", "--bpr_batch", "256", "--epochs", "1",
                          "--use_pop_gate", "--tensorboard", "0", "--checkpoint_dir", ck],
                         device=CPU)
    (rows, answers), text = _run(bench_serving.main, [
        "--checkpoint_dir", ck, "--dataset_dir", ds, "--reps", "4", "--artifact_dir",
        str(tmp_path), "--device", CPU])
    assert "restored @ epoch 1" in text and os.path.exists(tmp_path / "_bench_serving_int8.npz")
    printed = _json_rows(text)
    assert printed[:-1] == rows and printed[-1] == {"summary": rows}
    assert [(r["family"], r["quant"], r["batch"]) for r in rows] == [
        ("graph", "fp32", 1), ("graph", "fp32", 256), ("graph", "int8", 1), ("graph", "int8", 256),
        ("seq-sasrec", "fp32", 1), ("seq-sasrec", "fp32", 64)]
    common = {"family", "quant", "batch", "p50_ms", "p99_ms", "ondevice_ms", "launches"}
    for r in rows[:4]:
        assert set(r) == common | {"users_per_s", "ondevice_users_per_s"}
    for r in rows[4:]:
        assert set(r) == common | {"sessions_per_s", "ondevice_sessions_per_s"}
    assert all(set(r["launches"]) == KERNELS for r in rows)
    # the fp32 answer is the trained model's top-20
    from gsrs_tpu_torch.serve import retriever_from_model

    ids, items = answers[("fp32", 256)]
    live, _ = retriever_from_model(tr.model, tr.data, device=CPU).recommend(ids, k=20)
    np.testing.assert_array_equal(items, live)
    sessions, seq_items = answers[("seq-sasrec", 64)]
    assert seq_items.shape == (64, 20)
    assert not any(set(s) & set(it.tolist()) for s, it in zip(sessions, seq_items))


def test_ondevice_ms_times_queued_calls():
    calls = []
    out0 = torch.zeros(3)
    ms = bench_serving.ondevice_ms(lambda: calls.append(1) or out0, (out0, out0), iters=7)
    assert len(calls) == 7 and ms >= 0
    assert bench_serving.pct([5, 1, 3, 2, 4], 50) == 3 and bench_serving.pct([1, 2], 99) == 2


# ---------------------------------------------------- bench_spmm_modes, bench_seq


def test_bench_spmm_modes_prints_the_jax_keys(tmp_path):
    ds = _dataset_dir(tmp_path)
    rows, text = _run(bench_spmm_modes.main, [
        "--dataset_dir", ds, "--batch", "256", "512", "--hybrid_cols", "16", "--tiled", "4:16",
        "--timed_epochs", "1", "--device", CPU])
    assert _json_rows(text) == rows
    assert [(r["spmm"], r["batch"]) for r in rows] == [
        (s, b) for s in ("ell", "hybrid16", "tiledG4C16") for b in (256, 512)]
    for r in rows:
        assert set(r) == {"spmm", "batch", "epoch_s", "vs_reference_33.5s", "last_loss",
                          "launches"}
        assert np.isfinite(r["last_loss"]) and r["epoch_s"] > 0
    # the three layouts compute the same products: equal losses at each batch
    losses = {b: {round(r["last_loss"], 3) for r in rows if r["batch"] == b} for b in (256, 512)}
    assert all(len(v) == 1 for v in losses.values())


def test_bench_seq_prints_the_jax_keys():
    out, text = _run(bench_seq.main, ["--n_users", "200", "--m_items", "60", "--max_len", "8",
                                      "--dim", "16", "--batch", "64", "--epochs", "1",
                                      "--device", CPU])
    rows = _json_rows(text)
    assert [r["model"] for r in rows] == list(bench_seq.KINDS) == list(out)
    for r in rows:
        assert set(r) == {"model", "epoch_s", "seqs_per_s", "eval_s", "recall@10", "launches"}
        assert 0 <= r["recall@10"] <= 1 and r["epoch_s"] > 0
    row, tr, state = out["sasrec"]
    assert state.epoch == 2 and tr.batch_size == 64 and row == rows[0]


# ------------------------------------------------- the package: device, imports


@pytest.mark.parametrize("tool", [t for t in TOOLS if t != "compute_ppr"])
def test_each_tool_raises_without_a_card(tmp_path, tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda:0")
    import importlib

    module = importlib.import_module(f"gsrs_tpu_torch.tools.{tool}")
    ds = _dataset_dir(tmp_path)
    argv = {"eval_checkpoint": ["--checkpoint_dir", str(tmp_path), "--data_root", str(tmp_path),
                                "--dataset", "tiny"],
            "bench_serving": ["--checkpoint_dir", str(tmp_path), "--dataset_dir", ds],
            "bench_eval": ["--dataset_dir", ds, "--skip_scale"],
            "visualize": ["gates", "--checkpoint_dir", str(tmp_path), "--dataset_dir", ds],
            "bench_spmm_modes": ["--dataset_dir", ds],
            "bench_seq": ["--n_users", "20", "--m_items", "10"],
            "bench_scaling": ["--n_users", "20", "--m_items", "10", "--devices", "1", "2"],
            "sweep_xsimgcl": ["--data_root", str(tmp_path), "--dataset", "tiny"],
            "profile_epoch": ["--data_root", str(tmp_path), "--dataset", "tiny"],
            "bench_scale_standin": ["--single", "--shapes", "yelp2018-scale"],
            "bench_seq_markov": ["--n_users", "20", "--m_items", "10"]}[tool]
    with pytest.raises(RuntimeError, match="no CUDA device"):  # no CPU fallback
        module.main(argv)


def test_the_tools_import_nothing_of_jax_and_run_as_modules(tmp_path):
    probe = ("import importlib, json, pkgutil, sys\n"
             "import gsrs_tpu_torch.tools as t\n"
             "mods = [m.name for m in pkgutil.walk_packages(t.__path__, 'gsrs_tpu_torch.tools.')]\n"
             "[importlib.import_module(m) for m in mods]\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'optax', 'orbax', 'gsrs_tpu'))\n"
             "print(json.dumps({'mods': mods, 'bad': bad}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [] and sorted(res["mods"]) == sorted(f"gsrs_tpu_torch.tools.{t}"
                                                             for t in TOOLS)
    ds = _dataset_dir(tmp_path)
    run = subprocess.run([sys.executable, "-m", "gsrs_tpu_torch.tools.compute_ppr",
                          "--dataset_dir", ds, "--out", str(tmp_path / "w.npy")], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0 and "shape (280, 4)" in run.stdout
    if not torch.cuda.is_available():
        run = subprocess.run([sys.executable, "-m", "gsrs_tpu_torch.tools.bench_eval",
                              "--dataset_dir", ds, "--skip_scale"], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=300)
        assert run.returncode != 0 and "no CUDA device" in run.stderr
