"""`Trainer.fit` of the port against the JAX trainer's loop.

Control flow: both trainers' ``train_epoch`` and ``evaluate`` return the
same scripted losses and metrics, then `fit` runs; the CSVs (without
``time_sec``), the checkpoint listings, ``model_meta.json``, the final
epoch, ``best_metric`` and the early-stop point must be equal. Then real
CPU runs: 2 epochs and a resume to 4 are bitwise the 4-epoch run,
``load_pretrained`` keeps epoch 0 and a fresh optimizer state, and the
final eval always runs."""

import csv
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from gsrs_tpu_torch import config as tcfg
from gsrs_tpu_torch.data import adjacency as tadj
from gsrs_tpu_torch.data import i2i as ti2i
from gsrs_tpu_torch.data import synthetic as tsyn
from gsrs_tpu_torch.models.lightgcn import ItemItemGraph
from gsrs_tpu_torch.models.registry import build_model
from gsrs_tpu_torch.train.trainer import Trainer

CPU = "cpu"
MODEL_KW = dict(num_layers=2, embedding_dim=8, use_pop_gate=True, pop_hidden=8, gate_hidden=8)


@pytest.fixture
def jax():
    return pytest.importorskip("jax", reason="the JAX package is the reference")


def _rows(path, drop=("time_sec",)):
    with open(path) as f:
        return [{k: v for k, v in r.items() if k not in drop} for r in csv.DictReader(f)]


def _script(trainer, losses, ndcgs):
    """Replace train_epoch/evaluate by scripted values; → the eval log."""
    evals = []

    def train_epoch(state):
        return dataclasses.replace(state, epoch=state.epoch + 1), losses[state.epoch]

    def evaluate(state):
        v = ndcgs[len(evals)]
        evals.append(state.epoch)
        return {"precision@10": v / 4, "recall@10": v / 2, "ndcg@10": v}

    trainer.train_epoch, trainer.evaluate = train_epoch, evaluate
    return evals


def _jax_trainer(tmp_path, train_kw):
    from gsrs_tpu.config import (
        EvalConfig as JEval, ExperimentConfig as JExp, ModelConfig as JModel,
        TrainConfig as JTrain,
    )
    from gsrs_tpu.data.adjacency import build_graph as jgraph
    from gsrs_tpu.data.synthetic import clustered as jclustered
    from gsrs_tpu.models.registry import build_model as jbuild
    from gsrs_tpu.ops.ell import ell_from_interactions as jell
    from gsrs_tpu.train.trainer import Trainer as JTrainer

    jd = jclustered(60, 80, seed=3)
    cfg = JExp(model=JModel(**MODEL_KW),
               train=JTrain(checkpoint_dir=str(tmp_path), tensorboard=False, **train_kw),
               eval=JEval(test_batch=32, topks=(10,)))
    g = jgraph(jd, 256)
    return JTrainer(cfg, jd, g, jbuild(cfg.model, g, ell=jell(jd)))


def _port_trainer(tmp_path, train_kw, model_kw=None, data=None, i2i=None):
    data = data or tsyn.clustered(60, 80, seed=3)
    cfg = tcfg.ExperimentConfig(
        model=tcfg.ModelConfig(**(model_kw or MODEL_KW)),
        train=tcfg.TrainConfig(checkpoint_dir=str(tmp_path), tensorboard=False, **train_kw),
        eval=tcfg.EvalConfig(test_batch=32, topks=(10,)))
    graph = tadj.build_graph(data, 256)
    return Trainer(cfg, data, graph, build_model(cfg.model, graph, i2i, device=CPU), device=CPU)


_SCENARIOS = {
    # evals at 0, 2, 4, 6 and a final one at 7; bests pruned to one; periodic at 3, 6
    "cadence": (dict(epochs=7, eval_every=2, save_every=3, keep_topk=1),
                [0.1, 0.3, 0.2, 0.35, 0.3]),
    # early stop after 2 evals without improvement; 'last' every 3 epochs
    "early_stop": (dict(epochs=10, eval_every=1, early_stop_evals=2, save_last_every=3,
                        save_every=4), [0.1, 0.2, 0.15, 0.12, 0.5, 0.6]),
    # no eval in the loop: the final one still runs
    "final_only": (dict(epochs=5, eval_every=0, save_every=0), [0.2]),
    # eval_every that does not divide the epochs: the final eval after epoch 5;
    # a step-indexed lr schedule in the CSVs
    "uneven": (dict(epochs=5, eval_every=3, save_every=2, keep_topk=3, use_scheduler=True,
                    sched_milestones=(2, 4)), [0.3, 0.1, 0.4]),
}


@pytest.mark.parametrize("name", list(_SCENARIOS))
def test_control_flow_matches_the_jax_trainer(jax, tmp_path, name):
    train_kw, ndcgs = _SCENARIOS[name]
    losses = [0.7 - 0.01 * e for e in range(train_kw["epochs"])]
    runs = []
    for kind, make in (("jax", _jax_trainer), ("port", _port_trainer)):
        root = tmp_path / kind
        tr = make(root, dict(train_kw, batch_size=64))
        evals = _script(tr, losses, ndcgs)
        state = tr.fit(verbose=False)
        with open(root / "model_meta.json") as f:
            meta = json.load(f)
        runs.append(dict(evals=evals, epoch=state.epoch, best=state.best_metric, meta=meta,
                         listing=sorted(os.listdir(root)),
                         train=_rows(root / "train_epoch_metrics.csv"),
                         valid=_rows(root / "valid_epoch_metrics.csv")))
    jrun, trun = runs
    for key in jrun:
        assert trun[key] == jrun[key], key
    assert trun["valid"][-1]["epoch"] == str(trun["epoch"])  # the final state is evaluated
    if name == "early_stop":
        assert trun["epoch"] == 3 and trun["evals"] == [0, 1, 2, 3]


def _i2i_setup():
    data = tsyn.clustered(60, 80, seed=3)
    return data, ItemItemGraph.from_scipy(ti2i.build_item_item(data, "cooc", 5))


@pytest.mark.parametrize("fused", ["off", "pallas"])
def test_resume_is_bitwise_the_uninterrupted_run(tmp_path, fused):
    """i2i smoothing and the pop gate on; 2 epochs, then --resume to 4,
    against 4 epochs at once: parameters, losses and metrics equal."""
    data, i2i = _i2i_setup()
    model_kw = dict(MODEL_KW, use_item_item=True, i2i_alpha=0.2)
    kw = dict(batch_size=64, lr=1e-2, eval_every=1, save_every=2, fused_adam=fused)

    whole = _port_trainer(tmp_path / "whole", dict(kw, epochs=4), model_kw, data, i2i)
    s_whole = whole.fit(verbose=False)
    first = _port_trainer(tmp_path / "split", dict(kw, epochs=2), model_kw, data, i2i)
    assert first.fit(verbose=False).epoch == 2
    second = _port_trainer(tmp_path / "split", dict(kw, epochs=4, resume=True), model_kw,
                           data, i2i)
    s_split = second.fit(verbose=False)

    assert s_split.epoch == s_whole.epoch == 4
    assert s_split.best_metric == s_whole.best_metric
    assert s_split.opt_state.count == s_whole.opt_state.count == 4 * whole.steps_per_epoch
    for name, p in s_whole.params.items():
        assert torch.equal(p, s_split.params[name]), name
    for f in ("train_epoch_metrics.csv", "valid_epoch_metrics.csv"):
        w = _rows(tmp_path / "whole" / f)
        s = _rows(tmp_path / "split" / f)
        if f.startswith("valid"):  # the resumed run evaluates epoch 2 again before training
            s = s[:2] + s[3:]
        assert s == w, f


def test_load_pretrained_keeps_epoch_zero_and_a_fresh_optimizer(tmp_path, capsys):
    kw = dict(batch_size=64, lr=1e-2, eval_every=0, save_every=1)
    src = _port_trainer(tmp_path, dict(kw, epochs=1))
    trained = {k: p.detach().clone() for k, p in src.fit(verbose=False).params.items()}
    tr = _port_trainer(tmp_path, dict(kw, epochs=0, load_pretrained=True))
    state = tr.fit(verbose=False)  # no epoch: only the restore and the final eval
    assert "[load] restored pretrained weights" in capsys.readouterr().out
    assert state.epoch == 0 and state.opt_state.count == 0
    assert not state.opt_state.optimizer.state  # no moments yet
    for name, p in state.params.items():
        assert torch.equal(p, trained[name]), name
    missing = _port_trainer(tmp_path / "empty", dict(kw, epochs=0, load_pretrained=True))
    missing.fit(verbose=False)
    assert "[load] WARNING: no pretrained checkpoint (lgn-clustered-60x80-2-8)" in \
        capsys.readouterr().out


@pytest.mark.parametrize("eval_every,epochs,want", [(0, 2, ["2"]), (2, 3, ["0", "2", "3"]),
                                                    (1, 2, ["0", "1", "2"])])
def test_the_final_eval_always_runs(tmp_path, eval_every, epochs, want):
    tr = _port_trainer(tmp_path, dict(batch_size=256, eval_every=eval_every, epochs=epochs))
    state = tr.fit(verbose=False)
    rows = _rows(tmp_path / "valid_epoch_metrics.csv", drop=())
    assert [r["epoch"] for r in rows] == want
    assert all(float(r["time_sec"]) >= 0 and np.isfinite(float(r["ndcg@10"])) for r in rows)
    assert abs(state.best_metric - max(float(r["ndcg@10"]) for r in rows)) <= 5e-7
    assert sorted(os.listdir(tmp_path))[-3:] == ["model_meta.json", "train_epoch_metrics.csv",
                                                 "valid_epoch_metrics.csv"]
