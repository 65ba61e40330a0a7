"""The port's tools that read a training run (`gsrs_tpu_torch.tools`:
eval_checkpoint, visualize, compute_ppr) against the JAX package's
(``tools/``), on the CPU: the port with ``--device cpu``, JAX on the CPU
with its scoring through the plain reference.

- eval_checkpoint: a JAX Orbax checkpoint and a port checkpoint of the
  same parameters (`convert.params_from_jax`, `seq_params_from_jax`),
  a pop-gate LightGCN with i2i smoothing and a SASRec; the two tools'
  metrics within 1e-6 and their printed lines equal. A port CLI run (the
  fused Adam's optimizer state in its checkpoint) and a `seq_cli` run
  with exact top-k: the tool reproduces the last row of
  ``valid_epoch_metrics.csv`` within 1e-6. No checkpoint: `SystemExit`.
- visualize: `gate_values` equals the JAX model's `final_embeddings`
  gate within 1e-6; `curve_series` reads the port's CSVs; the plots are
  written where matplotlib is installed.
- compute_ppr: the weights and ``main``'s .npy equal the JAX tool's
  within rtol 1e-12.
"""

import contextlib
import csv
import dataclasses
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from gsrs_tpu_torch.data import synthetic as tsyn
from gsrs_tpu_torch.data.dataset import write_interaction_file
from gsrs_tpu_torch.tools import compute_ppr, eval_checkpoint, visualize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
METRIC_ATOL = 1e-6
GATE_ATOL = 1e-6
# a pop-gate LightGCN with i2i smoothing, small
GRAPH_KW = dict(num_layers=2, embedding_dim=16, use_pop_gate=True, pop_hidden=8, gate_hidden=16,
                use_item_item=True, i2i_alpha=0.3, pop_gate_temp=0.7)
SEQ_META = dict(kind="sasrec", max_len=10, dim=16, hidden=16, blocks=2, heads=2)


def _dataset_dir(root, name="tiny"):
    d = tsyn.clustered(120, 160, seed=3)
    path = os.path.join(root, name)
    os.makedirs(path)
    write_interaction_file(os.path.join(path, "train.txt"), d.train_users, d.train_items)
    tu = np.concatenate([np.full(len(v), k) for k, v in d.test_dict.items()])
    write_interaction_file(os.path.join(path, "test.txt"), tu,
                           np.concatenate(list(d.test_dict.values())))
    return path


def _with_i2i(ds):
    from gsrs_tpu_torch.data import i2i

    path = os.path.join(ds, "i2i.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        i2i.main(["--dataset_dir", ds, "--scheme", "jaccard", "--out", path])
    return path


def _jax_tool(name):
    """The JAX package's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax_main(monkeypatch, module, argv):
    """The JAX tool's ``main()`` (it reads sys.argv) → its standard output."""
    monkeypatch.setattr(sys, "argv", [module.__file__] + list(argv))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module.main()
    return buf.getvalue()


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(argv)
    return out, buf.getvalue()


def _eval_line(text):
    (line,) = [ln for ln in text.splitlines() if ln.startswith("[eval e")]
    return line


def _capture(monkeypatch, cls, name):
    """Record what ``cls.name`` returns."""
    seen = []
    original = getattr(cls, name)

    def wrapper(self, *a, **kw):
        seen.append(original(self, *a, **kw))
        return seen[-1]

    monkeypatch.setattr(cls, name, wrapper)
    return seen


def _assert_metrics_close(got, want):
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= METRIC_ATOL, (k, got[k], want[k])


# ------------------------------------------------------------ eval_checkpoint


def _graph_checkpoints(tmp_path, ds, i2i_path):
    """A JAX checkpoint and a port checkpoint of the same seeded pop-gate
    parameters at epoch 3, each beside the JAX package's model_meta.json."""
    from gsrs_tpu.config import (ExperimentConfig as JExp, ModelConfig as JModel,
                                 TrainConfig as JTrain)
    from gsrs_tpu.data.adjacency import build_graph as jgraph
    from gsrs_tpu.data.dataset import load_dataset as jload
    from gsrs_tpu.models.registry import build_model as jbuild
    from gsrs_tpu.train.trainer import Trainer as JTrainer

    from gsrs_tpu_torch.config import ExperimentConfig, ModelConfig, TrainConfig
    from gsrs_tpu_torch.convert import params_from_jax
    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.data.dataset import load_dataset
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.train.trainer import Trainer

    kw = dict(GRAPH_KW, i2i_path=i2i_path)
    jdir, pdir = str(tmp_path / "jck"), str(tmp_path / "pck")
    jdata = jload(ds)
    jcfg = JExp(model=JModel(**kw), train=JTrain(checkpoint_dir=jdir, tensorboard=False))
    jtr = JTrainer(jcfg, jdata, jgraph(jdata), jbuild(jcfg.model, jgraph(jdata)), run_eval=False)
    jstate = jtr.init_state()
    jtr.save_last(dataclasses.replace(jstate, epoch=3))

    data = load_dataset(ds)
    cfg = ExperimentConfig(model=ModelConfig(**kw), train=TrainConfig(checkpoint_dir=pdir,
                                                                      tensorboard=False))
    model = build_model(cfg.model, build_graph(data), device=CPU)
    tr = Trainer(cfg, data, build_graph(data), model, run_eval=False, device=CPU)
    state = tr.init_state()
    model.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in jstate.params.items()},
                                          cfg.model, CPU))
    tr.save_last(dataclasses.replace(state, epoch=3))
    meta = json.dumps(dataclasses.asdict(JModel(**kw)))
    for d in (jdir, pdir):  # the JAX package's meta, read by both
        with open(os.path.join(d, "model_meta.json"), "w") as f:
            f.write(meta)
    return jdir, pdir, jstate.params


def test_eval_checkpoint_graph_matches_jax(tmp_path, monkeypatch):
    pytest.importorskip("jax", reason="the JAX package is the reference")
    pytest.importorskip("orbax.checkpoint", reason="the JAX package's checkpoints are Orbax")
    from gsrs_tpu.train.trainer import Trainer as JTrainer

    ds = _dataset_dir(tmp_path)
    jdir, pdir, _ = _graph_checkpoints(tmp_path, ds, _with_i2i(ds))
    base = ["--data_root", str(tmp_path), "--dataset", "tiny"]
    seen = _capture(monkeypatch, JTrainer, "evaluate")
    jtext = _run_jax_main(monkeypatch, _jax_tool("eval_checkpoint"), ["--checkpoint_dir", jdir]
                          + base)
    got, text = _run(eval_checkpoint.main, ["--checkpoint_dir", pdir, "--device", CPU] + base)
    _assert_metrics_close(got, seen[0])
    assert _eval_line(text) == _eval_line(jtext) == "[eval e3] " + " ".join(
        f"{k}={v:.5f}" for k, v in sorted(got.items()))
    assert "checkpoint epoch 3" in text


def test_eval_checkpoint_sasrec_matches_jax(tmp_path, monkeypatch):
    jax = pytest.importorskip("jax", reason="the JAX package is the reference")
    pytest.importorskip("orbax.checkpoint", reason="the JAX package's checkpoints are Orbax")
    from gsrs_tpu.data.dataset import load_dataset as jload
    from gsrs_tpu.data.sequences import sequences_from_interactions as jseqs
    from gsrs_tpu.models.registry import build_seq_model as jbuild
    from gsrs_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
    from gsrs_tpu.train.seq_trainer import SeqTrainer as JSeqTrainer

    from gsrs_tpu_torch.convert import seq_params_from_jax
    from gsrs_tpu_torch.data.dataset import load_dataset
    from gsrs_tpu_torch.data.sequences import sequences_from_interactions
    from gsrs_tpu_torch.models.registry import build_seq_model
    from gsrs_tpu_torch.train.checkpoint import CheckpointManager
    from gsrs_tpu_torch.train.seq_trainer import SeqTrainer

    ds = _dataset_dir(tmp_path)
    hp = {k: v for k, v in SEQ_META.items() if k not in ("kind", "max_len")}
    L = SEQ_META["max_len"]
    jdata = jseqs(jload(ds), max_len=L)
    jtr = JSeqTrainer(jbuild("sasrec", jdata.m_items, max_len=L, **hp), jdata)
    jstate = jtr.init_state()
    params = jtr.model.init_params(jax.random.key(7))  # not the trainer's seed
    jstate = dataclasses.replace(jstate, params=params, epoch=2)
    jdir, pdir = str(tmp_path / "jck"), str(tmp_path / "pck")
    JCheckpointManager(jdir).save_last(jtr._ckpt_state(jstate))

    tdata = sequences_from_interactions(load_dataset(ds), max_len=L)
    ttr = SeqTrainer(build_seq_model("sasrec", tdata.m_items, max_len=L, device=CPU, **hp), tdata,
                     device=CPU)
    state = ttr.init_state()
    ttr.model.load_state_dict(seq_params_from_jax({k: np.asarray(v) for k, v in params.items()},
                                                  "sasrec", CPU))
    CheckpointManager(pdir).save_last(ttr.ckpt_state(dataclasses.replace(state, epoch=2)))
    meta = json.dumps(dict(SEQ_META, m_items=int(jdata.m_items)))
    for d in (jdir, pdir):
        with open(os.path.join(d, "model_meta.json"), "w") as f:
            f.write(meta)

    base = ["--data_root", str(tmp_path), "--dataset", "tiny", "--topks", "[5,20]",
            "--testbatch", "64"]
    seen = _capture(monkeypatch, JSeqTrainer, "evaluate")
    jtext = _run_jax_main(monkeypatch, _jax_tool("eval_checkpoint"), ["--checkpoint_dir", jdir]
                          + base)
    got, text = _run(eval_checkpoint.main, ["--checkpoint_dir", pdir, "--device", CPU] + base)
    _assert_metrics_close(got, seen[0])
    assert _eval_line(text) == _eval_line(jtext)
    assert "checkpoint epoch 2 (sasrec)" in text and got["recall@20"] > 0


def _last_valid_row(ckpt):
    with open(os.path.join(ckpt, "valid_epoch_metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    return {k: float(v) for k, v in rows[-1].items() if "@" in k}


@pytest.mark.parametrize("family", ["graph", "sequential"])
def test_eval_checkpoint_reproduces_the_runs_last_eval(tmp_path, family):
    from gsrs_tpu_torch import cli, seq_cli

    ds = _dataset_dir(tmp_path)
    ck = str(tmp_path / "ck")
    base = ["--data_root", str(tmp_path), "--dataset", "tiny", "--checkpoint_dir", ck,
            "--epochs", "2", "--eval_every", "1"]
    with contextlib.redirect_stdout(io.StringIO()):
        if family == "graph":
            cli.main(base + ["--layer", "2", "--recdim", "16", "--bpr_batch", "256",
                             "--use_pop_gate", "--use_item_item", "--i2i_path", _with_i2i(ds),
                             "--fused_adam", "pallas", "--tensorboard", "0"], device=CPU)
            extra = []
        else:
            seq_cli.main(base + ["--dim", "16", "--hidden", "16", "--max_len", "10", "--batch",
                                 "64"], device=CPU)
            extra = ["--testbatch", "256", "--topks", "[10,20]"]  # the run's eval
    got, text = _run(eval_checkpoint.main, ["--checkpoint_dir", ck, "--data_root", str(tmp_path),
                                            "--dataset", "tiny", "--device", CPU] + extra)
    want = _last_valid_row(ck)
    _assert_metrics_close(got, want)
    assert "[eval e2]" in text


def test_eval_checkpoint_without_a_checkpoint_raises(tmp_path):
    ds = _dataset_dir(tmp_path)
    base = ["--data_root", str(tmp_path), "--dataset", "tiny", "--device", CPU]
    with pytest.raises(SystemExit, match="no checkpoint under"):
        _run(eval_checkpoint.main, ["--checkpoint_dir", str(tmp_path / "none")] + base)
    seq_dir = tmp_path / "seq"
    seq_dir.mkdir()
    (seq_dir / "model_meta.json").write_text(json.dumps(dict(SEQ_META, m_items=160)))
    with pytest.raises(SystemExit, match="no checkpoint under"):
        _run(eval_checkpoint.main, ["--checkpoint_dir", str(seq_dir)] + base)
    assert os.path.isdir(ds)


# ------------------------------------------------------------------ visualize


def test_gate_values_match_jax_final_embeddings(tmp_path):
    pytest.importorskip("jax", reason="the JAX package is the reference")
    pytest.importorskip("orbax.checkpoint", reason="the JAX package's checkpoints are Orbax")
    import scipy.sparse as sp

    from gsrs_tpu.config import ModelConfig as JModel
    from gsrs_tpu.data.adjacency import build_graph as jgraph
    from gsrs_tpu.data.dataset import load_dataset as jload
    from gsrs_tpu.models.lightgcn import ItemItemGraph as JItemItem
    from gsrs_tpu.models.registry import build_model as jbuild
    from gsrs_tpu.ops.ell import ell_from_interactions as jell

    ds = _dataset_dir(tmp_path)
    i2i_path = _with_i2i(ds)
    _, pdir, params = _graph_checkpoints(tmp_path, ds, i2i_path)
    jdata = jload(ds)
    jm = jbuild(JModel(**GRAPH_KW, i2i_path=i2i_path), jgraph(jdata),
                i2i=JItemItem.from_scipy(sp.load_npz(i2i_path)), ell=jell(jdata))
    want = np.asarray(jm.final_embeddings(params)[2])
    with contextlib.redirect_stdout(io.StringIO()):
        gate, pop = visualize.gate_values(pdir, ds, CPU)
    assert gate.shape == want.shape == (160,)
    np.testing.assert_allclose(gate, want, rtol=0, atol=GATE_ATOL)
    np.testing.assert_allclose(pop, np.log1p(np.asarray(jdata.item_degrees, np.float64)),
                               rtol=1e-12)
    assert 0.0 < gate.min() and gate.max() < 1.0


def test_gates_refuse_a_run_without_the_pop_gate_and_a_missing_checkpoint(tmp_path):
    from gsrs_tpu_torch.config import ModelConfig

    ds = _dataset_dir(tmp_path)
    ck = tmp_path / "ck"
    ck.mkdir()
    (ck / "model_meta.json").write_text(json.dumps(dataclasses.asdict(ModelConfig())))
    with pytest.raises(SystemExit, match="without the pop gate"):
        visualize.gate_values(str(ck), ds, CPU)
    with pytest.raises(SystemExit, match="no checkpoint found"):
        visualize.gate_values(str(tmp_path / "none"), ds, CPU)


def test_curve_series_reads_the_csvs_and_the_plots_are_drawn(tmp_path):
    from gsrs_tpu_torch import cli

    ds = _dataset_dir(tmp_path)
    ck = str(tmp_path / "ck")
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["--data_root", str(tmp_path), "--dataset", "tiny", "--layer", "1", "--recdim",
                  "8", "--bpr_batch", "256", "--epochs", "3", "--eval_every", "1",
                  "--use_pop_gate", "--tensorboard", "0", "--checkpoint_dir", ck], device=CPU)
    series = visualize.curve_series(ck)
    assert series["train"]["epoch"] == [1.0, 2.0, 3.0]
    assert series["train"]["lr"] == [1e-3] * 3 and len(series["train"]["train_loss"]) == 3
    assert series["valid"]["epoch"] == [0.0, 1.0, 2.0, 3.0]
    assert set(series["valid"]) == {"epoch", "recall@20", "precision@20", "ndcg@20"}
    with open(os.path.join(ck, "valid_epoch_metrics.csv")) as f:
        last = list(csv.DictReader(f))[-1]
    assert series["valid"]["ndcg@20"][-1] == float(last["ndcg@20"])
    assert visualize.curve_series(str(tmp_path / "none")) == {"train": {}, "valid": {}}
    pytest.importorskip("matplotlib", reason="the plots need matplotlib")
    for argv in (["curves", "--checkpoint_dir", ck, "--out", str(tmp_path / "c.png")],
                 ["gates", "--checkpoint_dir", ck, "--dataset_dir", ds, "--out",
                  str(tmp_path / "g.png"), "--device", CPU]):
        _, text = _run(visualize.main, argv)
        assert text.strip().endswith(".png")
    assert os.path.getsize(tmp_path / "c.png") > 0 and os.path.getsize(tmp_path / "g.png") > 0


# ---------------------------------------------------------------- compute_ppr


@pytest.mark.parametrize("alpha,layers", [(0.15, 3), (0.5, 1), (0.05, 5)])
def test_compute_ppr_weights_match_jax(alpha, layers):
    import scipy.sparse as sp

    jtool = _jax_tool("compute_ppr")
    rng = np.random.default_rng(layers)
    R = sp.random(30, 45, density=0.1, random_state=rng, format="csr")
    R.data[:] = 1.0
    adj = sp.bmat([[None, R], [R.T, None]], format="csr", dtype=np.float64)  # isolated nodes too
    got = compute_ppr.compute_ppr_weights(adj, alpha, layers)
    want = jtool.compute_ppr_weights(adj, alpha, layers)
    assert got.shape == (75, layers + 1) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-12)


def test_compute_ppr_main_writes_the_jax_tools_weights(tmp_path, monkeypatch):
    ds = _dataset_dir(tmp_path)
    jout, pout = str(tmp_path / "j.npy"), str(tmp_path / "p.npy")
    args = ["--dataset_dir", ds, "--alpha", "0.2", "--layers", "4"]
    _run_jax_main(monkeypatch, _jax_tool("compute_ppr"), args + ["--out", jout])
    W, text = _run(compute_ppr.main, args + ["--out", pout])
    assert text.strip() == f"wrote {pout}: shape (280, 5)"
    np.testing.assert_allclose(np.load(pout), np.load(jout), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(np.load(pout), W)
    assert torch.get_default_dtype() == torch.float32  # nothing here changed torch's state
