"""The port's checkpoints: a round trip through the trainer for both
optimizer families (torch Adam, "off"; the fused update, "jnp"), with the
next step bitwise equal after the restore; crash recovery from a stranded
``.tmp`` and ``.old``; keep-top-K pruning; the error on a missing explicit
resume path; and the directory listing after the same sequence of saves
against the JAX package's `CheckpointManager` (Orbax, on the test side
only)."""

import os

import numpy as np
import pytest
import torch

from gsrs_tpu_torch import config as tcfg
from gsrs_tpu_torch.data import adjacency as tadj
from gsrs_tpu_torch.data import synthetic as tsyn
from gsrs_tpu_torch.models.registry import build_model
from gsrs_tpu_torch.train.checkpoint import STATE_FILE, CheckpointManager, legacy_name
from gsrs_tpu_torch.train.fused_adam import FusedAdamState
from gsrs_tpu_torch.train.trainer import Trainer

CPU = "cpu"


def _trainer(tmp_path, fused):
    data = tsyn.clustered(60, 80, seed=3)
    cfg = tcfg.ExperimentConfig(
        model=tcfg.ModelConfig(num_layers=2, embedding_dim=8, use_pop_gate=True, pop_hidden=8,
                               gate_hidden=8),
        train=tcfg.TrainConfig(batch_size=64, lr=1e-2, fused_adam=fused,
                               checkpoint_dir=str(tmp_path), use_scheduler=True,
                               sched_milestones=(1,), sched_gamma=0.5),
        eval=tcfg.EvalConfig(test_batch=32, topks=(10,)))
    graph = tadj.build_graph(data, 256)
    return Trainer(cfg, data, graph, build_model(cfg.model, graph, device=CPU), device=CPU)


def _opt_tensors(opt_state):
    if isinstance(opt_state, FusedAdamState):
        return [opt_state.mu[k] for k in opt_state.mu] + [opt_state.nu[k] for k in opt_state.nu]
    st = opt_state.optimizer.state_dict()["state"]
    return [st[i][k] for i in sorted(st) for k in ("step", "exp_avg", "exp_avg_sq")]


@pytest.mark.parametrize("fused", ["off", "jnp"])
def test_round_trip_then_the_same_next_step(tmp_path, fused):
    a = _trainer(tmp_path, fused)
    state, _ = a.train_epoch(a.init_state())
    state = type(state)(state.params, state.opt_state, state.epoch, best_metric=0.25)
    a.save_last(state)
    saved = torch.load(os.path.join(tmp_path, "last", STATE_FILE), weights_only=True)
    assert all(t.device.type == "cpu" for t in saved["params"].values())
    assert saved["epoch"] == 1 and saved["opt_state"]["count"] == a.steps_per_epoch

    b = _trainer(tmp_path, fused)
    rb = b.maybe_resume(b.init_state(seed=7))  # other initial weights: all must come back
    assert (rb.epoch, rb.best_metric, rb.opt_state.count) == (1, 0.25, state.opt_state.count)
    for name, p in rb.params.items():
        assert torch.equal(p, state.params[name]), name
        assert p is dict(b.model.named_parameters())[name]  # restored into the live ones
    for x, y in zip(_opt_tensors(rb.opt_state), _opt_tensors(state.opt_state)):
        assert torch.equal(x, y)
    # the schedule's step index came back: the next epoch (past the lr
    # milestone) is bitwise the same on both
    assert b.current_lr(rb) == a.current_lr(state) == float(np.float32(5e-3))
    sa, la = a.train_epoch(state)
    sb, lb = b.train_epoch(rb)
    assert la == lb
    for name, p in sa.params.items():
        assert torch.equal(p, sb.params[name]), name


def test_resume_refuses_another_optimizer(tmp_path):
    a = _trainer(tmp_path, "off")
    a.save_last(a.init_state())
    b = _trainer(tmp_path, "jnp")
    with pytest.raises(ValueError, match="fused_adam"):
        b.maybe_resume(b.init_state())


def _state(v):
    return {"params": {"w": torch.full((3,), float(v))}, "epoch": v}


@pytest.mark.parametrize("stranded", [".tmp", ".old"])
def test_recovers_a_checkpoint_stranded_mid_swap(tmp_path, stranded):
    ck = CheckpointManager(str(tmp_path))
    ck.save_last(_state(1))
    os.rename(tmp_path / "last", tmp_path / f"last{stranded}")  # a crash between the renames
    assert ck.resolve_resume_path(None) == os.path.join(ck.dir, "last")
    assert ck.restore(os.path.join(ck.dir, "last"))["epoch"] == 1
    assert not os.path.exists(tmp_path / f"last{stranded}")
    # a stale .tmp beside a whole checkpoint is cleared by the next save
    os.makedirs(tmp_path / "last.tmp")
    ck.save_last(_state(2))
    assert sorted(os.listdir(tmp_path)) == ["last"]
    assert ck.restore(str(tmp_path / "last"))["epoch"] == 2


def test_keep_topk_prunes_the_oldest_bests(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    for e in (0, 2, 5, 11):
        ck.save_best(_state(e), e, keep_topk=2)
    assert sorted(os.listdir(tmp_path)) == ["best-epoch11", "best-epoch5"]
    ck.save_best(_state(12), 12)  # keep_topk 0 keeps all
    assert len(os.listdir(tmp_path)) == 3


def test_resume_chain_and_missing_explicit_path(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    legacy = legacy_name("lgn", "gowalla", 3, 64)
    assert legacy == "lgn-gowalla-3-64"
    assert ck.resolve_resume_path(None, legacy) is None
    ck.save_periodic(_state(3), legacy)
    assert ck.resolve_resume_path(None, legacy) == os.path.join(ck.dir, legacy)
    ck.save_last(_state(4))
    assert ck.resolve_resume_path(None, legacy) == os.path.join(ck.dir, "last")
    with pytest.raises(FileNotFoundError, match="does not exist"):
        ck.resolve_resume_path(str(tmp_path / "nope"), legacy)
    tr = _trainer(tmp_path / "run", "off")
    tr.cfg = tcfg.ExperimentConfig(train=tcfg.TrainConfig(
        checkpoint_dir=str(tmp_path / "run"), resume_path=str(tmp_path / "gone")))
    with pytest.raises(FileNotFoundError, match="resume_path"):
        tr.maybe_resume(tr.init_state())


def test_listing_matches_the_jax_checkpoint_manager(tmp_path):
    pytest.importorskip("orbax.checkpoint", reason="the JAX package's checkpoints are Orbax")
    import jax.numpy as jnp

    from gsrs_tpu.train.checkpoint import CheckpointManager as JCheckpointManager

    legacy = legacy_name("lgn", "tiny", 2, 8)
    listings = []
    for root, manager, state in (
        (tmp_path / "jax", JCheckpointManager, lambda v: {"w": jnp.full((3,), float(v))}),
        (tmp_path / "port", CheckpointManager, _state),
    ):
        ck = manager(str(root))
        for e in range(1, 7):
            ck.save_last(state(e))
            if e % 2 == 0:
                ck.save_periodic(state(e), legacy)
            if e in (1, 3, 4, 6):
                ck.save_best(state(e), e, keep_topk=2)
        os.makedirs(root / "best-epoch3.tmp")  # a stale sibling, recovered by neither
        ck.resolve_resume_path(None, legacy)
        listings.append(sorted(os.listdir(root)))
    assert listings[0] == listings[1] == sorted(
        ["last", legacy, "best-epoch4", "best-epoch6", "best-epoch3.tmp"])


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the run on the card uses the CUDA kernels")
    return torch.device("cuda:0")


def _trainer_on(tmp_path, fused, device):
    data = tsyn.clustered(60, 80, seed=3)
    cfg = tcfg.ExperimentConfig(
        model=tcfg.ModelConfig(num_layers=2, embedding_dim=8, use_pop_gate=True),
        train=tcfg.TrainConfig(batch_size=64, lr=1e-2, fused_adam=fused,
                               checkpoint_dir=str(tmp_path)),
        eval=tcfg.EvalConfig(test_batch=32, topks=(10,)))
    graph = tadj.build_graph(data, 256)
    return Trainer(cfg, data, graph, build_model(cfg.model, graph, device=device), device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("fused", ["off", "pallas"])
def test_checkpoints_cross_between_the_card_and_the_cpu(cuda, tmp_path, fused):
    """Written on the card, restored on the CPU, and the other way round:
    the same parameters, moments and step count."""
    card = _trainer_on(tmp_path / "a", fused, cuda)
    state, _ = card.train_epoch(card.init_state())
    card.save_last(state)
    cpu = _trainer_on(tmp_path / "a", fused, CPU)
    got = cpu.maybe_resume(cpu.init_state(seed=9))
    assert got.epoch == 1 and got.opt_state.count == state.opt_state.count
    for name, p in got.params.items():
        assert torch.equal(p, state.params[name].cpu()), name
    for x, y in zip(_opt_tensors(got.opt_state), _opt_tensors(state.opt_state)):
        assert torch.equal(x.cpu(), y.cpu())
    cpu.save_last(got)  # and back onto the card
    back = _trainer_on(tmp_path / "a", fused, cuda)
    again = back.maybe_resume(back.init_state(seed=11))
    for name, p in again.params.items():
        assert p.device.type == "cuda" and torch.equal(p.cpu(), got.params[name]), name
