"""The port's training path against the JAX package on JAX-CPU: the BPR
loss and its gradients, the step-indexed schedule, fused Adam against
optax and torch.optim.Adam, and three trainer steps from converted JAX
parameters and optimizer state against the JAX trainer's epoch function
on the same triplets. Then a CPU drive of the clustered set, and (marked
``gpu``, on a CUDA card only) the fused Adam kernel against its plain
version."""

import dataclasses

import numpy as np
import pytest
import torch

from gsrs_tpu_torch import config as tcfg
from gsrs_tpu_torch.convert import opt_state_from_jax, params_from_jax
from gsrs_tpu_torch.data import adjacency as tadj
from gsrs_tpu_torch.data import synthetic as tsyn
from gsrs_tpu_torch.models.registry import build_model
from gsrs_tpu_torch.ops.ell import ell_from_interactions
from gsrs_tpu_torch.train import fused_adam as tfa
from gsrs_tpu_torch.train.optim import lr_schedule, make_optimizer
from gsrs_tpu_torch.train.trainer import Trainer

CPU = "cpu"
GRAD_ATOL = 1e-6  # fp32 loss and gradients, summation order only
ADAM_ATOL = 2e-6  # fp32 Adam trajectories (lr ≤ 1e-2) over a few steps


@pytest.fixture
def jax():
    return pytest.importorskip("jax", reason="the JAX package is the reference")


def _jax_cfg_kw(**model_kw):
    return dict(num_layers=2, embedding_dim=8, pop_hidden=8, gate_hidden=16, **model_kw)


def _model_pair(jax, use_pop_gate, reg_mode="propagated"):
    from gsrs_tpu.config import ModelConfig as JaxModelConfig
    from gsrs_tpu.data import adjacency as jadj
    from gsrs_tpu.data import synthetic as jsyn
    from gsrs_tpu.models.registry import build_model as jax_build_model
    from gsrs_tpu.ops.ell import ell_from_interactions as jax_ell

    kw = _jax_cfg_kw(use_pop_gate=use_pop_gate, reg_mode=reg_mode)
    jd, td = jsyn.clustered(60, 80, seed=3), tsyn.clustered(60, 80, seed=3)
    jm = jax_build_model(JaxModelConfig(**kw), jadj.build_graph(jd, 256), ell=jax_ell(jd))
    params = jm.init_params(jax.random.key(1))
    tm = build_model(tcfg.ModelConfig(**kw), tadj.build_graph(td, 256),
                     ell=ell_from_interactions(td), device=CPU)
    tm.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in params.items()},
                                       tm.cfg, CPU))
    return jm, params, tm


@pytest.mark.parametrize("reg_mode,use_pop_gate", [
    ("propagated", False), ("ego", False), ("propagated", True), ("ego", True),
])
def test_bpr_loss_and_gradients_match_jax(jax, reg_mode, use_pop_gate):
    jm, params, tm = _model_pair(jax, use_pop_gate, reg_mode)
    rng = np.random.default_rng(0)
    users, pos, neg = rng.integers(0, 60, 64), rng.integers(0, 80, 64), rng.integers(0, 80, 64)

    def loss_fn(p):
        loss, aux = jm.bpr_loss(p, users, pos, neg)
        return loss + 1e-2 * aux["reg"], (loss, aux)

    (_, (jloss, jaux)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    loss, aux = tm.bpr_loss(*(torch.from_numpy(a) for a in (users, pos, neg)))
    (loss + 1e-2 * aux["reg"]).backward()

    assert set(aux) == set(jaux)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=GRAD_ATOL)
    for k in aux:
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]), atol=GRAD_ATOL)
    want = params_from_jax({k: np.asarray(v) for k, v in jgrads.items()}, tm.cfg, CPU)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=GRAD_ATOL,
                                   err_msg=name)


def test_lr_schedule_matches_optax_at_every_step(jax):
    from gsrs_tpu.config import TrainConfig as JaxTrainConfig
    from gsrs_tpu.train.optim import lr_schedule as jax_schedule

    kw = dict(lr=3e-3, use_scheduler=True, sched_milestones=(2, 5), sched_gamma=0.3)
    steps_per_epoch = 7
    ours = lr_schedule(tcfg.TrainConfig(**kw), steps_per_epoch)
    theirs = jax_schedule(JaxTrainConfig(**kw), steps_per_epoch)
    for count in range(8 * steps_per_epoch):
        assert ours(count) == float(np.float32(theirs(count))), count
    # a boundary b scales the updates from count b on, not before
    assert ours(2 * 7 - 1) == float(np.float32(3e-3)) != ours(2 * 7)
    constant = lr_schedule(tcfg.TrainConfig(lr=3e-3), steps_per_epoch)
    assert constant(10**6) == float(np.float32(3e-3))


def _adam_inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    params = {"user_emb": rng.standard_normal((37, 16)) * 0.1,
              "item_emb": rng.standard_normal((37, 11)) * 0.1}
    grads = [{k: rng.standard_normal(v.shape) for k, v in params.items()} for _ in range(5)]
    cast = {torch.float32: np.float32, torch.bfloat16: np.float32}[dtype]
    return ({k: v.astype(cast) for k, v in params.items()},
            [{k: v.astype(cast) for k, v in g.items()} for g in grads])


def _run_port_adam(opt, params_np, grads_np, dtype):
    params = {k: torch.nn.Parameter(torch.from_numpy(v).to(dtype)) for k, v in params_np.items()}
    state = opt.init(params)
    for g in grads_np:
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k]).to(dtype)
        state = opt.step(params, state)
        assert all(p.grad is None for p in params.values())
    return params, state


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("scheduled", [False, True])
def test_fused_adam_matches_optax_and_torch(jax, backend, scheduled):
    import jax.numpy as jnp
    import optax

    from gsrs_tpu.config import TrainConfig as JaxTrainConfig
    from gsrs_tpu.train.optim import lr_schedule as jax_schedule

    kw = dict(lr=1e-2, use_scheduler=scheduled, sched_milestones=(3,), sched_gamma=0.5)
    sched = lr_schedule(tcfg.TrainConfig(**kw), 1)
    params_np, grads_np = _adam_inputs(torch.float32)
    fused, fstate = _run_port_adam(tfa.FusedAdam(schedule=sched, backend=backend), params_np,
                                   grads_np, torch.float32)
    assert fstate.count == 5

    ref = optax.adam(learning_rate=jax_schedule(JaxTrainConfig(**kw), 1))
    p_ref = {k: jnp.asarray(v) for k, v in params_np.items()}
    s_ref = ref.init(p_ref)
    for g in grads_np:
        upd, s_ref = ref.update({k: jnp.asarray(v) for k, v in g.items()}, s_ref, p_ref)
        p_ref = optax.apply_updates(p_ref, upd)

    torch_params = {k: torch.nn.Parameter(torch.from_numpy(v)) for k, v in params_np.items()}
    topt = torch.optim.Adam(torch_params.values(), lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
    for step, g in enumerate(grads_np):
        for group in topt.param_groups:
            group["lr"] = sched(step)
        for k, p in torch_params.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()

    for k, p in fused.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(p_ref[k]), atol=ADAM_ATOL)
        np.testing.assert_allclose(p.detach().numpy(), torch_params[k].detach().numpy(),
                                   atol=ADAM_ATOL)
    for k, p in fused.items():  # the moments too: optax keeps them in s_ref[0]
        np.testing.assert_allclose(fstate.mu[k].numpy(), np.asarray(s_ref[0].mu[k]), atol=1e-7)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_fused_adam_bf16_matches_jax_math(jax, backend):
    """bf16 leaves keep bf16 parameters and moments; each step is JAX's
    `_adam_math` on the same bf16 values."""
    import jax.numpy as jnp

    from gsrs_tpu.train.fused_adam import FusedAdam as JaxFusedAdam

    params_np, grads_np = _adam_inputs(torch.bfloat16, seed=1)
    sched = lr_schedule(tcfg.TrainConfig(lr=1e-2), 1)
    ported, state = _run_port_adam(tfa.FusedAdam(schedule=sched, backend=backend), params_np,
                                   grads_np, torch.bfloat16)
    jopt = JaxFusedAdam(schedule=lambda c: 1e-2, backend="jnp")
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params_np.items()}
    js = jopt.init(jp)
    for g in grads_np:
        jp, js = jopt.step(jp, {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()}, js)
    for k, p in ported.items():
        assert p.dtype == state.mu[k].dtype == state.nu[k].dtype == torch.bfloat16
        np.testing.assert_allclose(p.detach().float().numpy(), np.asarray(jp[k], np.float32),
                                   rtol=1e-2, atol=1e-3)


def test_make_optimizer_switch():
    cfg = tcfg.TrainConfig()
    off, _ = make_optimizer(cfg, 10)
    assert not isinstance(off, tfa.FusedAdam)
    for backend in ("jnp", "pallas"):
        opt, _ = make_optimizer(dataclasses.replace(cfg, fused_adam=backend), 10)
        assert isinstance(opt, tfa.FusedAdam) and opt.backend == backend
    with pytest.raises(ValueError):
        make_optimizer(dataclasses.replace(cfg, fused_adam="fast"), 10)


# ------------------------------------------------------- trainer vs the JAX trainer


def _trainers(jax, tmp_path, fused, data_seed=3):
    from gsrs_tpu.config import (
        EvalConfig as JEval, ExperimentConfig as JExp, ModelConfig as JModel,
        TrainConfig as JTrain,
    )
    from gsrs_tpu.data.adjacency import build_graph as jbuild_graph
    from gsrs_tpu.data.synthetic import clustered as jclustered
    from gsrs_tpu.models.registry import build_model as jbuild_model
    from gsrs_tpu.ops.ell import ell_from_interactions as jell
    from gsrs_tpu.train.trainer import Trainer as JTrainer

    jd, td = jclustered(60, 80, seed=data_seed), tsyn.clustered(60, 80, seed=data_seed)
    B = -(-td.train_size // 3)  # 3 steps per epoch: a milestone at epoch 1 is count 3
    train_kw = dict(batch_size=B, lr=1e-2, decay=1e-3, use_scheduler=True,
                    sched_milestones=(1,), sched_gamma=0.5, fused_adam=fused)
    model_kw = _jax_cfg_kw(use_pop_gate=True)
    jcfg = JExp(model=JModel(**model_kw),
                train=JTrain(checkpoint_dir=str(tmp_path), tensorboard=False, **train_kw),
                eval=JEval(test_batch=32, topks=(10,)))
    jgraph = jbuild_graph(jd, edge_pad_multiple=256)
    jtr = JTrainer(jcfg, jd, jgraph, jbuild_model(jcfg.model, jgraph, ell=jell(jd)))
    tcfg_ = tcfg.ExperimentConfig(model=tcfg.ModelConfig(**model_kw),
                                  train=tcfg.TrainConfig(**train_kw),
                                  eval=tcfg.EvalConfig(test_batch=32, topks=(10,)))
    tgraph = tadj.build_graph(td, edge_pad_multiple=256)
    tm = build_model(tcfg_.model, tgraph, ell=ell_from_interactions(td), device=CPU)
    ttr = Trainer(tcfg_, td, tgraph, tm, device=CPU)
    return jtr, ttr


@pytest.mark.parametrize("fused", ["off", "pallas"])
def test_run_steps_match_the_jax_trainer(jax, tmp_path, fused):
    """Two JAX steps give a non-trivial optimizer state; it and the
    parameters are converted, then both trainers take the same three
    steps, across the lr milestone at count 3."""
    import jax.numpy as jnp

    jtr, ttr = _trainers(jax, tmp_path, fused)
    epoch_fn = jtr._build_epoch_fn()
    state = jtr.init_state()
    params, opt_state = state.params, state.opt_state
    rng = np.random.default_rng(9)
    B = ttr.cfg.train.batch_size

    def triplets(n):
        return (rng.integers(0, 60, (n, B)), rng.integers(0, 80, (n, B)),
                rng.integers(0, 80, (n, B)))

    def jax_step(params, opt_state, batch):
        u, p, n = (jnp.asarray(a, jnp.int32) for a in batch)
        keys = jax.random.split(jax.random.key(0), u.shape[0])
        return epoch_fn(params, opt_state, jtr.graph, jtr.model.ell, u, p, n, keys)

    params, opt_state, _ = jax_step(params, opt_state, triplets(2))
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731  (donated below)
    params_np, opt_np = to_np(params), to_np(opt_state)

    ttr.model.load_state_dict(params_from_jax(params_np, ttr.cfg.model, CPU))
    tstate = ttr.init_state()
    ttr.model.load_state_dict(params_from_jax(params_np, ttr.cfg.model, CPU))
    tstate = dataclasses.replace(tstate, opt_state=opt_state_from_jax(opt_np, ttr.cfg, ttr.model))

    batch = triplets(3)
    jlosses = []
    for s in range(3):
        params, opt_state, loss = jax_step(params, opt_state, tuple(a[s:s + 1] for a in batch))
        jlosses.append(float(loss))
    tstate, tlosses = ttr.run_steps(tstate, *batch)

    np.testing.assert_allclose(tlosses.numpy(), jlosses, rtol=2e-4)
    want = params_from_jax(to_np(params), ttr.cfg.model, CPU)
    for name, p in ttr.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=ADAM_ATOL,
                                   err_msg=name)


def test_train_epoch_chunks_and_state(tmp_path):
    """train_epoch: mean loss of its steps, the epoch count, chunking by
    steps_per_scan, a reproducible stream, and a falling loss."""
    data = tsyn.clustered(60, 80, seed=3)

    def trainer(spc):
        cfg = tcfg.ExperimentConfig(
            model=tcfg.ModelConfig(num_layers=2, embedding_dim=8),
            train=tcfg.TrainConfig(batch_size=64, lr=5e-2, steps_per_scan=spc,
                                   fused_adam="pallas"),
            eval=tcfg.EvalConfig(test_batch=32, topks=(10,)))
        graph = tadj.build_graph(data, edge_pad_multiple=256)
        return Trainer(cfg, data, graph, build_model(cfg.model, graph, device=CPU), device=CPU)

    tr = trainer(2)
    state = tr.init_state()
    losses = []
    for _ in range(4):
        state, loss = tr.train_epoch(state)
        losses.append(loss)
    assert state.epoch == 4 and state.opt_state.count == 4 * tr.steps_per_epoch
    assert losses[-1] < losses[0]
    again = trainer(2)
    s2 = again.init_state()
    _, first = again.train_epoch(s2)
    assert first == losses[0]
    assert tr.current_lr(state) == float(np.float32(5e-2))
    with pytest.raises(ValueError, match="steps_per_scan"):
        trainer(-2).train_epoch(trainer(-2).init_state())
    assert set(tr.evaluate(state)) == {"recall@10", "precision@10", "ndcg@10"}


def test_edge_dropout_masks_every_layer_alike():
    """With cfg.dropout and a generator, one canonical-order keep mask
    (0 or 1/keep_prob per edge) scales every layer; without cfg.dropout
    the generator is ignored. A dropout epoch trains."""
    from gsrs_tpu_torch.ops.ell import ell_propagate_layer
    from gsrs_tpu_torch.ops.spmm import edge_keep_mask

    data = tsyn.clustered(60, 80, seed=3)
    graph = tadj.build_graph(data, edge_pad_multiple=256)
    cfg = tcfg.ModelConfig(num_layers=2, embedding_dim=8, dropout=True, keep_prob=0.6)
    model = build_model(cfg, graph, device=CPU)
    keep = edge_keep_mask(torch.Generator().manual_seed(5), graph, 0.6)
    assert keep.shape == (graph.edge_w_by_u.shape[0],)
    assert set(keep.unique().tolist()) == {0.0, float(torch.tensor(1 / 0.6))}
    assert abs(float(keep.mean()) - 1.0) < 0.05
    with torch.no_grad():
        got = model.propagate(torch.Generator().manual_seed(5))
        cur = acc = (model.user_emb, model.item_emb)
        for _ in range(2):
            cur = ell_propagate_layer(model.ell, *cur, keep)
            acc = (acc[0] + cur[0], acc[1] + cur[1])
        plain = model.propagate()
    for a, b in zip(got, acc):
        torch.testing.assert_close(a, b / 3, atol=1e-6, rtol=0)
    assert not torch.allclose(got[0], plain[0])
    off = build_model(dataclasses.replace(cfg, dropout=False), graph, device=CPU)
    with torch.no_grad():
        torch.testing.assert_close(off.propagate(torch.Generator().manual_seed(5))[0],
                                   off.propagate()[0])
    ecfg = tcfg.ExperimentConfig(model=cfg, train=tcfg.TrainConfig(batch_size=256))
    tr = Trainer(ecfg, data, graph, model, device=CPU)
    state, loss = tr.train_epoch(tr.init_state())
    assert np.isfinite(loss)
    with pytest.raises(ValueError, match="dropout_generator"):
        tr.run_steps(state, *(np.zeros((1, 4), np.int64),) * 3)


def test_trainer_refuses_what_is_not_ported():
    data = tsyn.clustered(30, 40, seed=0)
    graph = tadj.build_graph(data, edge_pad_multiple=256)
    model = build_model(tcfg.ModelConfig(num_layers=1, embedding_dim=4), graph, device=CPU)
    mesh = tcfg.ExperimentConfig(parallel=tcfg.ParallelConfig(data_axis=2))
    with pytest.raises(RuntimeError, match="process group"):  # a mesh needs its ranks
        Trainer(mesh, data, graph, model, device=CPU)
    with pytest.raises(ValueError, match="the model is on cpu"):
        Trainer(tcfg.ExperimentConfig(), data, graph, model, device="meta")


def test_cpu_drive_learns_the_clusters():
    from gsrs_tpu_torch.drive import drive

    out = drive(CPU)
    assert out["loss_first"] > 0.6 and out["loss_last"] < 0.1, out
    assert out["recall20"] > 0.3, out  # chance ≈ 20/300
    assert out["bad_triplets"] == 0 and out["leaked_positives"] == 0, out


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ with no CPU mode")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(37, 11), (29858, 64), (5,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_the_card(cuda, shape, dtype):
    """Three steps across a milestone: the kernel and `_adam_math` on the
    same card tensors."""
    sched = lr_schedule(tcfg.TrainConfig(lr=1e-2, use_scheduler=True, sched_milestones=(2,),
                                         sched_gamma=0.5), 1)
    g = torch.Generator(device=cuda).manual_seed(0)
    p0 = (0.1 * torch.randn(shape, device=cuda, generator=g)).to(dtype)
    grads = [torch.randn(shape, device=cuda, generator=g).to(dtype) for _ in range(3)]
    runs = []
    for backend in ("pallas", "jnp"):
        p = torch.nn.Parameter(p0.clone())
        opt = tfa.FusedAdam(schedule=sched, backend=backend)
        state = opt.init({"p": p})
        before = tfa.LAUNCHES["fused_adam"]
        for gr in grads:
            p.grad = gr.clone()
            state = opt.step({"p": p}, state)
        launched = tfa.LAUNCHES["fused_adam"] - before
        assert launched == (3 if backend == "pallas" else 0)
        torch.cuda.synchronize()
        runs.append((p.detach(), state.mu["p"], state.nu["p"]))
    for got, want in zip(*runs):
        assert got.dtype == want.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), atol=2e-6, rtol=0)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    p = torch.zeros(8, 4, device=cuda)
    args = (1e-2, 10.0, 1000.0, 0.9, 0.999, 1e-8)
    with pytest.raises(TypeError):
        tfa.fused_adam_(p, p.clone(), p.clone(), p.double(), *args)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.fused_adam_(p.T, p.T.clone(), p.T.clone(), p.T.clone(), *args)
    with pytest.raises(ValueError, match="different devices"):
        tfa.fused_adam_(p, p.clone(), p.clone(), p.cpu(), *args)
