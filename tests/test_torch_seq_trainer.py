"""The port's sequential trainer (`gsrs_tpu_torch.train.seq_trainer`) and
command line (`gsrs_tpu_torch.seq_cli`) against the JAX package's.

- Steps: the JAX trainer's own epoch function on the batches and step
  keys its `train_epoch` makes, against the port's `run_steps` handed the
  same batches and JAX's draws of those keys (negatives, dropout masks,
  BERT4Rec's corruption), from the same parameters and optimizer state
  (`convert.seq_params_from_jax`, `seq_opt_state_from_jax`, also after a
  JAX step, with non-zero moments): the mean loss within 1e-5 and the
  parameters after Adam within 5e-5 (fp32 sums in another order, through
  Adam's lr·m/(sqrt(v) + ε), whose slope peaks where |g| ≲ ε).
- Eval: the metrics of the same parameters within 1e-6 (K1's plain
  version here against JAX's `mask_train_positives` + `topk_scores`).
- `fit`: JAX's checkpoint and resume test, ported; a resume equal to a
  run that never stopped, bit for bit; meshes raise naming A7.
"""

import csv
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="the JAX package is the reference these tests compare with")
pytest.importorskip("orbax", reason="the JAX package's trainer, the reference, imports orbax")

import jax
import jax.numpy as jnp

from gsrs_tpu.data.sequences import synthetic_markov_sequences as jmarkov
from gsrs_tpu.models.registry import build_seq_model as jbuild
from gsrs_tpu.train.seq_trainer import SeqTrainer as JSeqTrainer
from gsrs_tpu_torch import seq_cli
from gsrs_tpu_torch.convert import seq_opt_state_from_jax, seq_params_from_jax
from gsrs_tpu_torch.data.sequences import synthetic_markov_sequences as tmarkov
from gsrs_tpu_torch.models.bert4rec import ClozeDraws
from gsrs_tpu_torch.models.registry import SEQ_MODELS, build_seq_model
from gsrs_tpu_torch.train.seq_trainer import SeqTrainer, SeqTrainState, StepDraws

M, L, D, B = 50, 10, 16, 16
LOSS_TOL, PARAM_ATOL, METRIC_ATOL = 1e-5, 5e-5, 1e-6
DATA = dict(n_users=40, m_items=M, n_clusters=5, max_len=L, seed=1)


def models(kind, dropout=0.2):
    kw = dict(max_len=L, dim=D, hidden=D, blocks=2, heads=2 if kind != "gru4rec" else 1,
              dropout=dropout)
    return jbuild(kind, M, **kw), build_seq_model(kind, M, device="cpu", **kw)


def trainers(kind, lr=1e-2, decay=0.01, eval_batch=16):
    jm, tm = models(kind)
    kw = dict(batch_size=B, lr=lr, decay=decay, seed=3, topks=(5, 10), eval_batch=eval_batch)
    jtr = JSeqTrainer(jm, jmarkov(**DATA), **kw)
    ttr = SeqTrainer(tm, tmarkov(**DATA), device="cpu", **kw)
    return jtr, ttr


def np_tree(params):
    return {k: np.asarray(v) for k, v in params.items()}


def port_state(ttr, jparams, jopt):
    """The port's state holding JAX's parameters and optimizer state."""
    ttr.model.load_state_dict(seq_params_from_jax(np_tree(jparams), type(ttr.model).__name__
                                                  .lower(), "cpu"))
    params = dict(ttr.model.named_parameters())
    return SeqTrainState(params, seq_opt_state_from_jax(jopt, ttr.model, ttr.optimizer))


def jax_epoch_inputs(jtr, epoch=0):
    """The batches and step keys the JAX trainer's `train_epoch` makes."""
    key = jax.random.fold_in(jax.random.key(jtr.seed), epoch)
    k_perm, k_steps = jax.random.split(key)
    perm = jax.random.permutation(k_perm, jtr.train_seqs.shape[0])
    batches = jtr.train_seqs[perm].reshape(-1, jtr.batch_size, jtr.data.max_len)
    return batches, jax.random.split(k_steps, batches.shape[0])


def jax_draws(jtr, seqs, key):
    """JAX's draws of one step (its epoch body's), as the port takes them."""
    model, c = jtr.model, jtr.model.cfg
    k_neg, k_drop = jax.random.split(key)
    neg = jax.random.randint(k_neg, seqs.shape, 1, jtr.data.m_items + 1, dtype=jnp.int32)
    neg = jnp.where(seqs == 0, 0, neg)
    shape = (*seqs.shape, c.embedding_dim)

    def keep(k, n):
        if n == 1:
            return [torch.from_numpy(np.array(jax.random.bernoulli(k, 1 - c.dropout_rate,
                                                                   shape)))]
        return [torch.from_numpy(np.array(jax.random.bernoulli(jax.random.fold_in(k, i),
                                                               1 - c.dropout_rate, shape)))
                for i in range(1, n + 1)]

    kind = type(model).__name__.lower()
    if kind == "gru4rec":
        own = keep(k_drop, 1)
    elif kind == "sasrec":
        own = keep(k_drop, 1 + 2 * c.num_blocks)
    else:
        k_mask, k_d = jax.random.split(k_drop)
        corrupted, masked = model.cloze_mask(k_mask, seqs)
        own = ClozeDraws(torch.from_numpy(np.array(corrupted)).long(),
                         torch.from_numpy(np.array(masked)), keep(k_d, 1 + 2 * c.num_blocks))
    return StepDraws(torch.from_numpy(np.array(neg)).long(), own)


def assert_params_close(tparams, jparams, atol):
    for k, v in np_tree(jparams).items():
        np.testing.assert_allclose(tparams[k].detach().numpy(), v, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("kind", SEQ_MODELS)
def test_steps_match_jax_from_fresh_and_carried_state(kind):
    """3 steps from a fresh state, compared after each; and a second port
    state carried across from JAX's after its first step (Adam's moments
    and count non-zero) through steps 2 and 3."""
    jtr, ttr = trainers(kind)
    jstate = jtr.init_state()
    epoch_fn = jtr._build_epoch_fn(jstate)
    batches, keys = jax_epoch_inputs(jtr)
    assert batches.shape[0] >= 3
    tstate = port_state(ttr, jstate.params, jstate.opt_state)
    carried = None
    jparams, jopt = jstate.params, jstate.opt_state
    for i in range(3):
        draws = [jax_draws(jtr, batches[i], keys[i])]
        step = np.asarray(batches[i:i + 1])
        tstate, losses = ttr.run_steps(tstate, step, draws)
        if carried is not None:
            carried, _ = carried_tr.run_steps(carried, step, draws)
        jparams, jopt, jloss = epoch_fn(jparams, jopt, batches[i:i + 1], keys[i:i + 1])
        np.testing.assert_allclose(float(losses[0]), float(jloss), rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
        assert_params_close(tstate.params, jparams, PARAM_ATOL)
        assert tstate.opt_state.count == int(np.asarray(jopt[0].count)) == i + 1
        if carried is not None:
            assert_params_close(carried.params, jparams, PARAM_ATOL)
        if i == 0:
            carried_tr = SeqTrainer(models(kind)[1], tmarkov(**DATA), batch_size=B, lr=1e-2,
                                    decay=0.01, seed=3, device="cpu")
            carried = port_state(carried_tr, jparams, jopt)


@pytest.mark.parametrize("kind", SEQ_MODELS)
def test_evaluate_matches_jax(kind):
    """Several eval batches, the last one padded (40 users, batch 16)."""
    jtr, ttr = trainers(kind)
    jstate = jtr.init_state()
    tstate = port_state(ttr, jstate.params, jstate.opt_state)
    want = jtr.evaluate(jstate)
    got = ttr.evaluate(tstate)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])


def test_trainer_bitsets_and_padding_match_jax():
    jtr, ttr = trainers("sasrec")
    np.testing.assert_array_equal(ttr.train_seqs.numpy(), np.asarray(jtr.train_seqs))
    for name in ("hist_bitset", "target_bitset"):
        np.testing.assert_array_equal(getattr(ttr, name).numpy().view(np.uint32),
                                      np.asarray(getattr(jtr, name)))
    assert ttr.steps_per_epoch == jtr.train_seqs.shape[0] // B


def test_step_draws_follow_jax_conventions():
    """Negatives in [1, m] and 0 where the positive is PAD; SASRec draws
    1 + 2·blocks keep masks, GRU4Rec one, BERT4Rec its corruption too;
    the same generator seed gives the same draws."""
    for kind in SEQ_MODELS:
        _, ttr = trainers(kind)
        seqs = ttr.epoch_batches(0)[0]
        d1 = ttr.draw_step(seqs, torch.Generator().manual_seed(5))
        d2 = ttr.draw_step(seqs, torch.Generator().manual_seed(5))
        assert torch.equal(d1.neg, d2.neg)
        assert (d1.neg[seqs == 0] == 0).all() and (d1.neg[seqs != 0] >= 1).all()
        assert (d1.neg <= M).all()
        keep = d1.model.keep if kind == "bert4rec" else d1.model
        assert len(keep) == (1 if kind == "gru4rec" else 5)
        assert keep[0].shape == (B, L, D) and keep[0].dtype == torch.bool
        share = float(torch.stack(keep).float().mean())
        assert 0.75 < share < 0.85  # keep probability 1 − 0.2


def test_seq_trainer_fit_checkpoints_and_resumes(tmp_path):
    data = tmarkov(n_users=100, m_items=50, n_clusters=5, max_len=10, seed=1)

    def trainer():
        model = build_seq_model("sasrec", 50, max_len=10, dim=16, hidden=16, blocks=1,
                                dropout=0.0, device="cpu")
        return SeqTrainer(model, data, batch_size=50, topks=(10,), device="cpu")

    state = trainer().fit(epochs=3, checkpoint_dir=str(tmp_path), eval_every=2, verbose=False)
    assert state.epoch == 3
    assert (tmp_path / "last").is_dir()
    assert any(p.name.startswith("best-epoch") for p in tmp_path.iterdir())
    train_rows = (tmp_path / "train_epoch_metrics.csv").read_text().splitlines()
    assert len(train_rows) == 4  # header + 3 epochs
    valid_rows = (tmp_path / "valid_epoch_metrics.csv").read_text().splitlines()
    assert [int(r.split(",")[0]) for r in valid_rows[1:]] == [0, 2, 3]  # e0, e2, final e3
    state2 = trainer().fit(epochs=5, checkpoint_dir=str(tmp_path), eval_every=2, resume=True,
                           verbose=False)
    assert state2.epoch == 5
    with open(tmp_path / "train_epoch_metrics.csv") as f:
        assert [r["epoch"] for r in csv.DictReader(f)] == ["1", "2", "3", "4", "5"]


def test_fit_logs_match_jax_schemas(tmp_path):
    """The CSV headers, the lr and time cells JAX leaves empty, and
    ``model_meta.json``, written by both packages' fit."""
    jtr, ttr = trainers("gru4rec")
    jtr.fit(epochs=1, checkpoint_dir=str(tmp_path / "jax"), eval_every=1, verbose=False)
    ttr.fit(epochs=1, checkpoint_dir=str(tmp_path / "port"), eval_every=1, verbose=False)
    for name in ("train_epoch_metrics.csv", "valid_epoch_metrics.csv", "model_meta.json"):
        want = (tmp_path / "jax" / name).read_text().splitlines()
        got = (tmp_path / "port" / name).read_text().splitlines()
        if name == "model_meta.json":
            assert got == want
            continue
        assert got[0] == want[0]  # header
        for g, w in zip(got[1:], want[1:]):
            gr, wr = g.split(","), w.split(",")
            assert gr[0] == wr[0] and len(gr) == len(wr)
            for col, a, b in zip(want[0].split(","), gr, wr):
                if col in ("lr",) or (col == "time_sec" and "valid" in name):
                    assert a == b == ""


def test_resume_equals_a_run_that_never_stopped(tmp_path):
    """2 epochs, then a resume to 4 from the checkpoint, against 4 epochs
    without a stop: every parameter bit for bit. On the CPU, the
    embedding gathers' backward (``index_put_`` with accumulate) adds in a
    thread-dependent order unless deterministic algorithms are asked for;
    on the card it is sort-based and deterministic."""
    data = tmarkov(n_users=60, m_items=40, n_clusters=4, max_len=8, seed=2)

    def trainer():
        model = build_seq_model("bert4rec", 40, max_len=8, dim=16, hidden=16, blocks=1,
                                dropout=0.2, device="cpu")
        return SeqTrainer(model, data, batch_size=16, topks=(10,), device="cpu")

    ck = str(tmp_path / "ck")
    torch.use_deterministic_algorithms(True)
    try:
        trainer().fit(epochs=2, checkpoint_dir=ck, eval_every=2, verbose=False)
        resumed = trainer().fit(epochs=4, checkpoint_dir=ck, eval_every=2, resume=True,
                                verbose=False)
        whole = trainer().fit(epochs=4, eval_every=2, verbose=False)
    finally:
        torch.use_deterministic_algorithms(False)
    assert resumed.epoch == whole.epoch == 4
    for k, p in whole.params.items():
        assert torch.equal(p, resumed.params[k]), k
    assert resumed.opt_state.count == whole.opt_state.count == 4 * 4


def test_meshes_raise_naming_a7():
    """Meshes run since A7 (`tests/test_torch_seq_mesh.py`); what a mesh
    still refuses is said before any rank starts: NCCL asked for on the
    CPU, and a batch that does not divide by the data axis."""
    from gsrs_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="NCCL needs CUDA"):
        seq_cli.main(["--synthetic", "--data_axis", "2", "--epochs", "0", "--dist_backend",
                      "nccl"], device="cpu")
    _, tm = models("sasrec")
    with pytest.raises(ValueError, match="data axis"):
        SeqTrainer(tm, tmarkov(**DATA), batch_size=B, eval_batch=18,
                   mesh=Mesh(4, 1, 0, torch.device("cpu")), device="cpu")


def test_cli_trains_on_a_dataset_directory(tmp_path, capsys):
    """``seq_cli.main`` on a dataset directory (file order is time), with
    a checkpoint directory; the same flags through the JAX CLI read the
    same sequences."""
    from gsrs_tpu_torch.data.dataset import write_interaction_file

    rng = np.random.default_rng(0)
    ddir = tmp_path / "data" / "toy"
    os.makedirs(ddir)
    users = np.repeat(np.arange(30), 6)
    items = rng.integers(0, 45, users.size)
    write_interaction_file(str(ddir / "train.txt"), users, items)
    argv = ["--data_root", str(tmp_path / "data"), "--dataset", "toy", "--model", "gru4rec",
            "--max_len", "5", "--dim", "8", "--hidden", "8", "--blocks", "1", "--batch", "8",
            "--epochs", "2", "--eval_every", "1", "--topks", "[5]",
            "--checkpoint_dir", str(tmp_path / "ck")]
    tr, state = seq_cli.main(argv, device="cpu")
    out = capsys.readouterr().out
    assert "[seq] toy: 30 sequences, 45 items, max_len 5" in out
    assert state.epoch == 2 and tr.batch_size == 8 and tr.topks == (5,)
    assert sorted(os.listdir(tmp_path / "ck"))[-3:] == [
        "model_meta.json", "train_epoch_metrics.csv", "valid_epoch_metrics.csv"]


def test_sasrec_learns_markov_structure():
    """The JAX package's learnability check, ported (and run here, where it
    takes about a second): recall@10 above twice its start and above 0.2
    (chance 0.1)."""
    data = tmarkov(n_users=300, m_items=100, n_clusters=5, max_len=20, seed=0)
    model = build_seq_model("sasrec", 100, max_len=20, dim=32, hidden=32, blocks=1,
                            dropout=0.0, device="cpu")
    trainer = SeqTrainer(model, data, batch_size=64, lr=3e-3, topks=(10,), device="cpu")
    state = trainer.init_state()
    first = trainer.evaluate(state)
    losses = []
    for _ in range(15):
        state, loss = trainer.train_epoch(state)
        losses.append(loss)
    final = trainer.evaluate(state)
    assert losses[-1] < losses[0] * 0.7
    assert final["recall@10"] > max(2 * first["recall@10"], 0.2), (first, final)
