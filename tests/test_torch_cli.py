"""The port's command line against the JAX package's: the flag surface
and its config (mirroring tests/test_config_cli.py), the unported flags'
errors, a CPU run of `main` on a small dataset directory (CSVs,
checkpoints, ``model_meta.json``, TensorBoard events), and ``serve
export`` from a port checkpoint holding JAX-converted parameters against
JAX's ``serve export`` from a JAX checkpoint of the same parameters (the
npz within 1e-5, int8 too; ``query`` prints the same lines, from either
package's artifact)."""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gsrs_tpu_torch import cli
from gsrs_tpu_torch.config import milestones_from_string, topks_from_string
from gsrs_tpu_torch.data import synthetic as tsyn
from gsrs_tpu_torch.data.dataset import write_interaction_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"

_ARGVS = {
    "defaults": [],
    "flags": ["--bpr_batch", "4096", "--recdim", "128", "--layer", "4", "--dropout", "1",
              "--use_pop_gate", "--use_item_item", "--i2i_path", "/tmp/x.npz",
              "--i2i_alpha", "0.25", "--use_scheduler", "--sched_milestones", "[10,20]",
              "--topks", "[10,20]", "--model", "mf", "--bf16", "--spmm", "segment"],
    "port_path": ["--dataset", "tiny", "--data_root", "/data", "--checkpoint_dir", "ck",
                  "--topk_method", "approx", "--topk_recall_target", "0.95",
                  "--fused_adam", "pallas", "--save_last_every", "5", "--eval_every", "1",
                  "--early_stop", "3", "--keep_topk", "2", "--save_every", "4", "--resume",
                  "--resume_path", "ck/last", "--load", "1", "--tensorboard", "0",
                  "--neg_candidates", "4", "--spmm", "tiled", "--tiled_groups", "64",
                  "--tiled_cols", "2048", "--use_pallas_scoring", "--reg_mode", "ego"],
    "ignored": ["--a_fold", "7", "--A_split", "--multicore", "1", "--use_ppr_weights",
                "--ppr_weights_path", "p.npz", "--exp_smooth_beta", "0.3", "--pretrain", "1",
                "--cl_lambda", "0.5", "--ug_neg_sharing", "pool", "--data_axis", "2",
                "--model_axis", "4", "--sched_milestones", "120,240"],
}


def _cfg(argv):
    return cli.config_from_args(cli.build_parser().parse_args(argv))


@pytest.mark.parametrize("name", list(_ARGVS))
def test_config_from_args_matches_jax(name):
    pytest.importorskip("jax", reason="the JAX package is the reference")
    from gsrs_tpu.cli import build_parser as jparser, config_from_args as jconfig

    argv = _ARGVS[name]
    got = dataclasses.asdict(_cfg(argv))
    want = dataclasses.asdict(jconfig(jparser().parse_args(argv)))
    # the default data_root is each package's repo root: the same directory here
    assert got["data"]["data_root"] == want["data"]["data_root"]
    assert got == want
    # the JAX package's flags, and the port's choice of a mesh's process-group backend
    assert sorted(a.dest for a in cli.build_parser()._actions) == \
        sorted([a.dest for a in jparser()._actions] + ["dist_backend"])


def test_defaults_and_parsers():
    cfg = _cfg([])
    assert (cfg.train.batch_size, cfg.model.embedding_dim, cfg.model.num_layers) == (2048, 64, 3)
    assert (cfg.train.lr, cfg.train.decay, cfg.train.epochs, cfg.train.seed) == \
        (1e-3, 1e-4, 1000, 2020)
    assert cfg.eval.topks == (20,) and cfg.train.sched_milestones == (120, 240, 360, 480)
    assert topks_from_string("[10, 20]") == (10, 20) and topks_from_string("20") == (20,)
    assert milestones_from_string("120,240") == (120, 240)
    assert milestones_from_string("500") == (500,)
    base = ["--dataset", "gowalla"]
    assert _cfg(base).eval.use_pallas_scoring == "auto"
    assert _cfg(base + ["--use_pallas_scoring"]).eval.use_pallas_scoring == "on"
    assert _cfg(base + ["--use_pallas_scoring", "off"]).eval.use_pallas_scoring == "off"


def test_set_seed_pins_the_global_streams():
    from gsrs_tpu_torch.utils import set_seed

    set_seed(123)
    a = (np.random.rand(3), torch.rand(3))
    set_seed(123)
    b = (np.random.rand(3), torch.rand(3))
    np.testing.assert_array_equal(a[0], b[0])
    assert torch.equal(a[1], b[1])


@pytest.mark.parametrize("spmm,item", [("tiled", "A7b"), ("hybrid", "A7b"), ("ell", None)])
def test_unported_flags_raise_naming_their_item(spmm, item):
    """Every flag runs on a mesh: the standalone mesh step takes every
    layout, the tiled and hybrid ones since their ROADMAP.md item (A7b)
    shards their dense blocks; a layout left unplaced on a mesh of more
    than one rank is refused, naming what to do."""
    from gsrs_tpu_torch import config as tcfg
    from gsrs_tpu_torch.data import adjacency as tadj
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.parallel.dist_train import make_train_step
    from gsrs_tpu_torch.parallel.mesh import Mesh, single_device_mesh
    from gsrs_tpu_torch.train.optim import ScheduledAdam

    data = tsyn.clustered(30, 40, seed=0)
    cfg = tcfg.ModelConfig(num_layers=1, embedding_dim=4, spmm_mode=spmm, tiled_groups=2,
                           tiled_cols=8, hybrid_cols=8)
    model = build_model(cfg, tadj.build_graph(data, edge_pad_multiple=256), device=CPU)
    optimizer = ScheduledAdam(lambda c: 1e-3)
    assert callable(make_train_step(model, optimizer, single_device_mesh(CPU), 0.0))
    with pytest.raises(ValueError, match="place_model"):
        make_train_step(model, optimizer, Mesh(2, 1, 0, torch.device(CPU)), 0.0)


def test_the_shell_entry_point_raises_without_a_card():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-m", "gsrs_tpu_torch", "--data_axis", "2"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    if not torch.cuda.is_available():  # the mesh's ranks would run on the card
        assert out.returncode != 0 and "no CUDA device" in out.stderr
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):  # no CPU fallback
        cli.main(["--dataset", "does-not-exist"])


def _dataset_dir(root, name="tiny"):
    d = tsyn.clustered(120, 160, seed=3)
    path = os.path.join(root, name)
    os.makedirs(path)
    write_interaction_file(os.path.join(path, "train.txt"), d.train_users, d.train_items)
    tu = np.concatenate([np.full(len(v), k) for k, v in d.test_dict.items()])
    write_interaction_file(os.path.join(path, "test.txt"), tu,
                           np.concatenate(list(d.test_dict.values())))
    return path


def test_main_on_the_cpu_writes_logs_checkpoints_and_meta(tmp_path):
    from gsrs_tpu_torch.data import i2i

    ds = _dataset_dir(tmp_path)
    i2i.main(["--dataset_dir", ds, "--out", os.path.join(ds, "i2i.npz")])
    ck = tmp_path / "ck"
    argv = ["--data_root", str(tmp_path), "--dataset", "tiny", "--layer", "2", "--recdim", "16",
            "--bpr_batch", "256", "--epochs", "3", "--eval_every", "1", "--use_pop_gate",
            "--use_item_item", "--i2i_path", os.path.join(ds, "i2i.npz"), "--topk_method",
            "approx", "--fused_adam", "pallas", "--save_every", "2", "--keep_topk", "1",
            "--checkpoint_dir", str(ck)]
    tr, state = cli.main(argv, device=CPU)
    assert state.epoch == 3 and tr.model.i2i is not None and tr.model.user_emb.device.type == "cpu"
    from gsrs_tpu_torch.train.logging import _summary_writer_class

    tb = _summary_writer_class() is not None  # TensorBoard events when a writer is installed
    listing = sorted(os.listdir(ck))
    bests = [n for n in listing if n.startswith("best-epoch")]
    assert len(bests) == 1
    assert set(listing) - set(bests) == {"last", "lgn-tiny-2-16", "model_meta.json",
                                         "train_epoch_metrics.csv", "valid_epoch_metrics.csv",
                                         *(["runs"] if tb else [])}
    with open(ck / "train_epoch_metrics.csv") as f:
        assert [r.split(",")[0] for r in f.read().split()[1:]] == ["1", "2", "3"]
    with open(ck / "valid_epoch_metrics.csv") as f:
        assert [r.split(",")[0] for r in f.read().split()[1:]] == ["0", "1", "2", "3"]
    with open(ck / "model_meta.json") as f:
        meta = json.load(f)
    assert meta == dataclasses.asdict(tr.cfg.model) and meta["use_item_item"]
    if tb:
        assert len(os.listdir(ck / "runs")) == 1
    # --resume continues from last, with the other top-k method
    resumed = list(argv)
    resumed[resumed.index("--epochs") + 1] = "4"
    resumed[resumed.index("approx")] = "threshold"
    again, state = cli.main(resumed + ["--resume"], device=CPU)
    assert state.epoch == 4
    with open(ck / "train_epoch_metrics.csv") as f:
        assert [r.split(",")[0] for r in f.read().split()[1:]] == ["1", "2", "3", "4"]
    assert again.cfg.eval.topk_method == "threshold"


ZOO_RUNS = {
    "mf": ["--model", "mf"],
    "ngcf": ["--model", "ngcf", "--dropout", "1"],
    "ngcf_segment": ["--model", "ngcf", "--spmm", "segment"],
    "xsimgcl": ["--model", "xsimgcl", "--spmm", "hybrid", "--hybrid_cols", "16"],
    "ultragcn_full": ["--model", "ultragcn", "--ug_neg_sharing", "full", "--ug_sift_pos"],
    "ultragcn_pool": ["--model", "ultragcn", "--ug_neg_sharing", "pool", "--ug_neg_pool", "64",
                      "--ug_neg_num", "16", "--ug_sift_pos"],
    "ultragcn_none": ["--model", "ultragcn", "--ug_neg_num", "16"],
    "lgn_hybrid": ["--spmm", "hybrid", "--hybrid_cols", "32", "--dropout", "1"],
    "lgn_segment": ["--spmm", "segment", "--dropout", "1"],
}


@pytest.mark.parametrize("name", list(ZOO_RUNS))
def test_every_model_and_layout_runs_and_exports(tmp_path, name):
    """A tiny two-epoch run of each model and layout on the CPU with the
    fused Adam path, its layout as asked, then ``serve export`` of its
    checkpoint equal to a Retriever of the trained model."""
    from gsrs_tpu_torch import serve as tserve
    from gsrs_tpu_torch.models.registry import MODELS
    from gsrs_tpu_torch.ops.ell import EllGraph
    from gsrs_tpu_torch.ops.hybrid import HybridGraph
    from gsrs_tpu_torch.serve import retriever_from_model

    _dataset_dir(tmp_path)
    ck = tmp_path / "ck"
    argv = ["--data_root", str(tmp_path), "--dataset", "tiny", "--layer", "2", "--recdim", "8",
            "--bpr_batch", "128", "--epochs", "2", "--eval_every", "1", "--fused_adam", "pallas",
            "--tensorboard", "0", "--checkpoint_dir", str(ck)] + ZOO_RUNS[name]
    tr, state = cli.main(argv, device=CPU)
    assert state.epoch == 2 and type(tr.model) is MODELS[name.split("_")[0]]
    # the segment layout runs on the ELL layout (ops/spmm.py)
    layout = {"hybrid": HybridGraph, "segment": EllGraph}.get(tr.cfg.model.spmm_mode)
    if layout is not None and tr.model.cfg.num_layers:
        assert isinstance(tr.model.ell, layout)
    if name.startswith(("mf", "ultragcn")):
        assert tr.model.ell is None and tr.model.cfg.num_layers == 0
    with open(ck / "train_epoch_metrics.csv") as f:
        losses = [float(r.split(",")[2]) for r in f.read().split()[1:]]
    assert len(losses) == 2 and np.isfinite(losses).all()
    if name.startswith("ultragcn"):
        assert os.path.exists(tmp_path / "tiny" / "ultragcn_ii_cache.npz")
    out = str(tmp_path / "emb.npz")
    _run(tserve.main, ["export", "--checkpoint_dir", str(ck), "--dataset_dir",
                       str(tmp_path / "tiny"), "--out", out, "--device", CPU])
    live = retriever_from_model(tr.model, tr.data, device=CPU)
    width = tr.model.cfg.embedding_dim * (3 if name.startswith("ngcf") else 1)
    with np.load(out) as z:
        assert z["item_emb"].shape == (160, width)
        np.testing.assert_allclose(z["user_emb"], live.user_emb.numpy(), atol=1e-5)
        np.testing.assert_allclose(z["item_emb"], live.item_emb.numpy(), atol=1e-5)


# ------------------------------------------------------------------ serve export


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


def test_serve_export_matches_jax(tmp_path):
    jax = pytest.importorskip("jax", reason="the JAX package is the reference")
    pytest.importorskip("orbax.checkpoint", reason="the JAX package's checkpoints are Orbax")
    from gsrs_tpu import serve as jserve
    from gsrs_tpu.config import ModelConfig as JModel, TrainConfig as JTrain
    from gsrs_tpu.data.adjacency import build_graph as jgraph
    from gsrs_tpu.data.dataset import load_dataset as jload
    from gsrs_tpu.models.registry import build_model as jbuild
    from gsrs_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
    from gsrs_tpu.train.optim import make_optimizer as jmake_optimizer

    from gsrs_tpu_torch import serve as tserve
    from gsrs_tpu_torch.config import ModelConfig
    from gsrs_tpu_torch.convert import params_from_jax
    from gsrs_tpu_torch.data import i2i
    from gsrs_tpu_torch.train.checkpoint import CheckpointManager

    ds = _dataset_dir(tmp_path)
    i2i_path = os.path.join(ds, "i2i.npz")
    i2i.main(["--dataset_dir", ds, "--scheme", "jaccard", "--out", i2i_path])
    kw = dict(num_layers=2, embedding_dim=16, use_pop_gate=True, pop_hidden=8, gate_hidden=16,
              use_item_item=True, i2i_path=i2i_path, i2i_alpha=0.3, pop_gate_temp=0.7)
    jm = jbuild(JModel(**kw), jgraph(jload(ds), 256))
    params = jm.init_params(jax.random.key(5))

    jdir, pdir = tmp_path / "jck", tmp_path / "pck"
    JCheckpointManager(str(jdir)).save_last({
        "params": params, "opt_state": jmake_optimizer(JTrain(), 1)[0].init(params),
        "epoch": np.asarray(0, np.int64), "best_metric": np.asarray(0.0, np.float64)})
    meta = json.dumps(dataclasses.asdict(JModel(**kw)))
    (jdir / "model_meta.json").write_text(meta)
    state = params_from_jax({k: np.asarray(v) for k, v in params.items()}, ModelConfig(**kw), CPU)
    CheckpointManager(str(pdir)).save_last({"params": state, "epoch": 0, "best_metric": 0.0})
    (pdir / "model_meta.json").write_text(meta)  # the JAX package's meta loads in the port

    outs = {}
    for quant in ([], ["--quantize", "int8"]):
        jout, pout = str(tmp_path / f"j{len(quant)}.npz"), str(tmp_path / f"p{len(quant)}.npz")
        _run(jserve.main, ["export", "--checkpoint_dir", str(jdir), "--dataset_dir", ds,
                           "--out", jout] + quant)
        _run(tserve.main, ["export", "--checkpoint_dir", str(pdir), "--dataset_dir", ds,
                           "--out", pout, "--device", CPU] + quant)
        outs[bool(quant)] = (jout, pout)
        with np.load(jout) as j, np.load(pout) as p:
            assert sorted(j.files) == sorted(p.files)
            np.testing.assert_array_equal(p["seen_bitset"], j["seen_bitset"])
            if not quant:
                for k in ("user_emb", "item_emb"):
                    np.testing.assert_allclose(p[k], j[k], atol=1e-5, err_msg=k)
            else:
                for k in ("user_emb", "item_emb"):
                    np.testing.assert_allclose(p[k + "_scale"], j[k + "_scale"], rtol=1e-5)
                    dq = np.abs(p[k + "_q"].astype(int) - j[k + "_q"].astype(int))
                    assert dq.max() <= 1 and (dq == 0).mean() > 0.999, k  # a rounding tie

    jout, pout = outs[False]
    q = ["query", "--users", "0", "1", "5", "119", "--k", "10"]
    lines = {
        "jax on jax": _run(jserve.main, q + ["--artifact", jout]),
        "port on port": _run(tserve.main, q + ["--artifact", pout, "--device", CPU]),
        "jax on port": _run(jserve.main, q + ["--artifact", pout]),
        "port on jax": _run(tserve.main, q + ["--artifact", jout, "--device", CPU]),
    }
    assert len(set(lines.values())) == 1, lines
    assert lines["port on port"].count("\n") == 4


def test_serve_export_without_meta_uses_the_flags(tmp_path):
    from gsrs_tpu_torch import serve as tserve
    from gsrs_tpu_torch.config import ModelConfig
    from gsrs_tpu_torch.train.checkpoint import CheckpointManager

    ds = _dataset_dir(tmp_path)
    cfg = ModelConfig(num_layers=1, embedding_dim=8)
    state = {"user_emb": torch.randn(120, 8), "item_emb": torch.randn(160, 8)}
    CheckpointManager(str(tmp_path / "ck")).save_periodic({"params": state},
                                                          "lgn-tiny-1-8")
    out = str(tmp_path / "emb.npz")
    text = _run(tserve.main, ["export", "--checkpoint_dir", str(tmp_path / "ck"),
                              "--dataset_dir", ds, "--out", out, "--layer", "1", "--recdim",
                              "8", "--device", CPU])
    assert "exported" in text and "using" not in text
    with np.load(out) as z:
        assert z["user_emb"].shape == (120, 8) and z["item_emb"].shape == (160, 8)
    assert cfg.num_layers == 1
    with pytest.raises(SystemExit, match="no checkpoint"):
        tserve.main(["export", "--checkpoint_dir", str(tmp_path / "none"), "--dataset_dir", ds,
                     "--out", out, "--device", CPU])
    # a model axis of 2 pads nothing here (120 x 160): the same canonical artifact
    out2 = str(tmp_path / "emb2.npz")
    tserve.main(["export", "--checkpoint_dir", str(tmp_path / "ck"), "--dataset_dir", ds,
                 "--out", out2, "--layer", "1", "--recdim", "8", "--model_axis", "2",
                 "--device", CPU])
    with np.load(out) as z, np.load(out2) as z2:
        for name in z.files:
            np.testing.assert_array_equal(z2[name], z[name])
