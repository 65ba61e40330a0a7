"""The sequential family on a (data, model) mesh of gloo ranks spawned on
the CPU (`SeqTrainer(mesh=...)`, `seq_cli --data_axis/--model_axis`),
against the JAX package's single-device trainer. The children import no
JAX: the parent hands down JAX's initial parameters, batches and step
draws (dropout keep masks, negatives, BERT4Rec's cloze corruption).

Three steps of each kind on a 2 × 2 mesh, and of SASRec on 4 × 1 and
1 × 4, give JAX's losses within a relative 2e-4 (JAX's own limit for its
mesh, `tests/test_distributed.py`) and its parameters within 5e-5 (the
port's one-card limit, `tests/test_torch_seq_trainer.py`); the eval of
those parameters gives JAX's metrics within 2e-4; no rank captures a step
in a CUDA graph (that is one card's path). A batch that does not divide by
the data axis is refused. Checkpoints hold the canonical item
table: a 2 × 2 ``seq_cli`` run's checkpoint resumes on one card, the
card's on a 4 × 1 mesh, and ``serve_seq export`` reads the result."""

import os

import numpy as np
import pytest
import torch

from gsrs_tpu_torch import seq_cli
from gsrs_tpu_torch.convert import seq_params_from_jax
from gsrs_tpu_torch.data.sequences import synthetic_markov_sequences
from gsrs_tpu_torch.models.registry import build_seq_model
from gsrs_tpu_torch.parallel.collectives import barrier
from gsrs_tpu_torch.parallel.launch import spawn
from gsrs_tpu_torch.parallel.mesh import Mesh, make_mesh
from gsrs_tpu_torch.train.seq_trainer import SeqTrainer, SeqTrainState, step_graph_counts

LOSS_RTOL, PARAM_ATOL, METRIC_RTOL = 2e-4, 5e-5, 2e-4
M, L, D, B = 50, 10, 16, 16
DATA = dict(n_users=40, m_items=M, n_clusters=5, max_len=L, seed=1)
RUNS = [("sasrec", (2, 2)), ("gru4rec", (2, 2)), ("bert4rec", (2, 2)), ("sasrec", (4, 1)),
        ("sasrec", (1, 4))]


def model_kw(kind):
    return dict(max_len=L, dim=D, hidden=D, blocks=2, heads=2 if kind != "gru4rec" else 1,
                dropout=0.2)


def port_trainer(kind, jparams, device, mesh=None):
    model = build_seq_model(kind, M, device=device, **model_kw(kind))
    model.load_state_dict(seq_params_from_jax(jparams, kind, device))
    return SeqTrainer(model, synthetic_markov_sequences(**DATA), batch_size=B, lr=1e-2,
                      decay=0.01, seed=3, topks=(5, 10), eval_batch=16, mesh=mesh,
                      device=device)


def cli_argv(ckpt, epochs, axes=None, resume=False):
    argv = ["--synthetic", "--model", "sasrec", "--max_len", "10", "--dim", "8", "--hidden",
            "8", "--blocks", "1", "--batch", "64", "--epochs", str(epochs), "--eval_every",
            "1", "--checkpoint_dir", ckpt, "--seed", "5"]
    if axes:
        argv += ["--data_axis", str(axes[0]), "--model_axis", str(axes[1])]
    return argv + (["--resume"] if resume else [])


def _seq_rank(device, inputs, ckpt):
    out = {}
    meshes = {}
    for kind, axes in RUNS:
        if axes not in meshes:
            meshes[axes] = make_mesh(data_axis=axes[0], model_axis=axes[1], device=device)
        jparams, batches, draws = inputs[kind]
        tr = port_trainer(kind, jparams, device, meshes[axes])
        params = dict(tr.model.named_parameters())
        state, losses = tr.run_steps(SeqTrainState(params, tr.optimizer.init(params)),
                                     batches, draws)
        out[(kind, axes)] = (losses, tr.ckpt_state(state)["params"], tr.evaluate(state))
        out.setdefault("optimizers", set()).add(type(tr.optimizer).__name__)
    out["step_graphs"] = step_graph_counts()
    seq_cli.main(cli_argv(ckpt, 1, (2, 2)), device=device)
    mesh = meshes[(2, 2)]
    barrier(mesh)
    if mesh.is_primary:  # the mesh's checkpoint on one card
        out["one_card"] = seq_cli.main(cli_argv(ckpt, 2, resume=True), device=device)[1].epoch
    barrier(mesh)
    trainer, state = seq_cli.main(cli_argv(ckpt, 3, (4, 1), resume=True), device=device)
    out["resumed"] = (state.epoch, trainer.n_train)
    return out


@pytest.fixture(scope="module")
def jax_side():
    from test_torch_seq_trainer import jax_draws, jax_epoch_inputs, np_tree, trainers

    out = {}
    for kind in dict(RUNS):
        jtr, _ = trainers(kind)
        jstate = jtr.init_state()
        epoch_fn = jtr._build_epoch_fn(jstate)
        batches, keys = jax_epoch_inputs(jtr)
        draws = [jax_draws(jtr, batches[i], keys[i]) for i in range(3)]
        initial = np_tree(jstate.params)  # the epoch function donates its inputs
        jparams, jopt, losses = jstate.params, jstate.opt_state, []
        for i in range(3):
            jparams, jopt, loss = epoch_fn(jparams, jopt, batches[i:i + 1], keys[i:i + 1])
            losses.append(float(loss))
        stepped = type(jstate)(jparams, jopt, 0)
        out[kind] = dict(inputs=(initial, np.asarray(batches[:3]), draws),
                         losses=losses, params=np_tree(jparams),
                         metrics=jtr.evaluate(stepped))
    return out


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("seq") / "ck")
    inputs = {kind: v["inputs"] for kind, v in jax_side.items()}
    return spawn(_seq_rank, 4, inputs, ckpt, device_type="cpu", timeout_s=300), ckpt


@pytest.mark.parametrize("kind,axes", RUNS)
def test_seq_trainer_on_mesh_matches_jax(ranks, jax_side, kind, axes):
    want = jax_side[kind]
    for r, out in enumerate(ranks[0]):
        losses, params, metrics = out[(kind, axes)]
        np.testing.assert_allclose(losses.numpy(), want["losses"], rtol=LOSS_RTOL)
        assert set(metrics) == set(want["metrics"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(metrics[k], v, rtol=METRIC_RTOL, err_msg=k)
        if r:
            continue
        want_params = seq_params_from_jax(want["params"], kind, "cpu")
        for k, v in want_params.items():
            np.testing.assert_allclose(params[k].numpy(), v.numpy(), rtol=0, atol=PARAM_ATOL,
                                       err_msg=k)


def test_seq_trainer_on_mesh_never_captures(ranks):
    """A mesh steps eagerly (its step sums shares across ranks): no rank
    captures or replays a step, and each takes `ScheduledAdam`."""
    for out in ranks[0]:
        assert out["step_graphs"] == {"captures": 0, "replays": 0}
        assert out["optimizers"] == {"ScheduledAdam"}


def test_seq_trainer_rejects_indivisible_batch():
    model = build_seq_model("gru4rec", 20, max_len=8, dim=8, hidden=8, blocks=1, device="cpu")
    data = synthetic_markov_sequences(n_users=32, m_items=20, max_len=8, seed=0)
    with pytest.raises(ValueError, match="data axis"):
        SeqTrainer(model, data, batch_size=30, mesh=Mesh(8, 1, 0, torch.device("cpu")),
                   device="cpu")


def test_seq_mesh_checkpoint_interop(ranks, tmp_path):
    out, ckpt = ranks[0][0], ranks[1]
    assert out["one_card"] == 2 and out["resumed"][0] == 3
    saved = torch.load(os.path.join(ckpt, "last", "state.pt"), weights_only=True)
    m_items = synthetic_markov_sequences(max_len=10, seed=5).m_items
    assert saved["epoch"] == 3 and saved["params"]["item_emb"].shape == (m_items + 1, 8)
    from gsrs_tpu_torch.serve_seq import load_seq_retriever, main

    art = str(tmp_path / "seq.npz")
    main(["export", "--checkpoint_dir", ckpt, "--out", art, "--device", "cpu"])
    r = load_seq_retriever(art, device="cpu")
    assert r.params["item_emb"].shape == (m_items + 1, 8)
    items, _ = r.recommend([[1, 2, 3]], k=5)
    assert items.shape == (1, 5)


def test_seq_cli_starts_its_own_ranks(tmp_path):
    """With no process group to join, the mesh flags start the ranks here
    (gloo on the CPU); rank 0 writes the checkpoint."""
    ckpt = str(tmp_path / "ck")
    assert seq_cli.main(cli_argv(ckpt, 1, (2, 1)), device="cpu") is None
    saved = torch.load(os.path.join(ckpt, "last", "state.pt"), weights_only=True)
    assert saved["epoch"] == 1
