"""The tiled and hybrid layouts on a (data, model) mesh of gloo ranks
spawned on the CPU: their dense hub blocks column-sharded over the whole
mesh, their residual ELLs row-sharded (`GraphShardings.tiled_spec`,
`hybrid_spec`), against the JAX package on one device.

As `tests/test_distributed.py` holds JAX's GSPMD tiled and hybrid steps
to its single device, the port's mesh step is held to JAX's
single-device step within JAX's own limits (losses rtol 1e-5, parameters
atol 1e-5): the tiled layout (4 groups × 16 hub columns) at mesh shapes
(1, 4), (2, 2) and (4, 1) and through the shard_map builder at (2, 2);
the hybrid layout (16 hub columns) at (2, 2); and both at 10 hub columns,
which do not divide by 4 ranks, so every rank holds the whole block and
rank 0 alone adds it. A control that adds that block on every rank must
fail the limits. Hash dropout on the mesh is held to the port's own
1 × 1 step with the same generator (the 1 × 1 hash-dropout step is held
to JAX by `test_torch_{hashdrop,tiled,hybrid}.py`). Each rank's dense
blocks hold C/size columns where C divides, all C where it does not. The
Trainer on a 2 × 2 mesh, which shards the layouts where the JAX Trainer
replicates them, equals the one-card Trainer.

The children import no JAX: the parent computes JAX's results and hands
its numbers down."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gsrs_tpu_torch.config import (
    EvalConfig, ExperimentConfig, ModelConfig, ParallelConfig, TrainConfig,
)
from gsrs_tpu_torch.convert import params_from_jax
from gsrs_tpu_torch.data.adjacency import build_graph
from gsrs_tpu_torch.data.synthetic import clustered
from gsrs_tpu_torch.models.registry import build_model
from gsrs_tpu_torch.ops.hybrid import hybrid_from_interactions
from gsrs_tpu_torch.ops.tiled import tiled_from_interactions
from gsrs_tpu_torch.parallel.collectives import all_gather_rows, psum
from gsrs_tpu_torch.parallel.dist_train import make_train_step
from gsrs_tpu_torch.parallel.launch import spawn
from gsrs_tpu_torch.parallel.mesh import make_mesh, single_device_mesh
from gsrs_tpu_torch.parallel.shard_map_train import make_shard_map_train_step
from gsrs_tpu_torch.parallel.sharding import GraphShardings
from gsrs_tpu_torch.train.optim import ScheduledAdam
from gsrs_tpu_torch.train.trainer import Trainer

LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5
GROUPS = 4
BUILDERS = {"gspmd": make_train_step, "shard_map": make_shard_map_train_step}
LAYOUTS = {  # name: (spmm_mode, hub columns)
    "tiled": ("tiled", 16), "hybrid": ("hybrid", 16),
    "tiled_c10": ("tiled", 10), "hybrid_c10": ("hybrid", 10),
}
DROPOUT = dict(dropout=True, keep_prob=0.6)
# (case, layout, mesh shape, builder, ModelConfig fields, the control)
CASES = (
    [(f"tiled-{d}x{m}", "tiled", (d, m), "gspmd", {}, False)
     for d, m in ((1, 4), (2, 2), (4, 1))]
    + [("tiled-shard_map", "tiled", (2, 2), "shard_map", {}, False),
       ("hybrid-2x2", "hybrid", (2, 2), "gspmd", {}, False),
       ("tiled_c10", "tiled_c10", (2, 2), "gspmd", {}, False),
       ("hybrid_c10", "hybrid_c10", (2, 2), "gspmd", {}, False),
       ("tiled_c10-control", "tiled_c10", (2, 2), "gspmd", {}, True),
       ("hybrid_c10-control", "hybrid_c10", (2, 2), "gspmd", {}, True),
       ("tiled-dropout", "tiled", (2, 2), "gspmd", DROPOUT, False),
       ("hybrid-dropout", "hybrid", (2, 2), "gspmd", DROPOUT, False),
       ("tiled_c10-dropout", "tiled_c10", (2, 2), "gspmd", DROPOUT, False),
       ("hybrid_c10-dropout", "hybrid_c10", (2, 2), "gspmd", DROPOUT, False)]
)
DIRECTIONS = ("user_from_item", "item_from_user")
TRAINER_LAYOUTS = ("tiled", "hybrid_c10")
METRIC_ATOL = 1e-6


def model_cfg(layout: str, **kw) -> ModelConfig:
    spmm, cols = LAYOUTS[layout]
    return ModelConfig(num_layers=2, embedding_dim=8, spmm_mode=spmm, tiled_groups=GROUPS,
                       tiled_cols=cols, hybrid_cols=cols, **kw)


def port_layout(layout: str, data):
    spmm, cols = LAYOUTS[layout]
    return (tiled_from_interactions(data, groups=GROUPS, cols=cols) if spmm == "tiled"
            else hybrid_from_interactions(data, cols=cols))


def port_model(layout: str, cfg_kw, jparams, device):
    data = clustered(64, 96, n_clusters=4, seed=1)
    cfg = model_cfg(layout, **cfg_kw)
    model = build_model(cfg, build_graph(data, edge_pad_multiple=256), None,
                        port_layout(layout, data), device=device)
    model.load_state_dict(params_from_jax(jparams, cfg, device))
    return model


def count_everywhere(model) -> None:
    """The control: every rank adds the whole dense block it holds."""
    model.ell = dataclasses.replace(model.ell, **{
        k: dataclasses.replace(getattr(model.ell, k), adds_dense=True) for k in DIRECTIONS})


def port_step(mesh, layout, builder, cfg_kw, jparams, batch, control=False):
    """One step of ``builder`` on ``mesh`` from JAX's parameters → (loss,
    the whole updated parameters, each direction's dense shape and
    whether this rank adds it)."""
    model = port_model(layout, cfg_kw, jparams, mesh.device)
    GraphShardings(mesh).place_model(model)
    if control:
        count_everywhere(model)
    blocks = {k: (tuple(getattr(model.ell, k).dense.shape), getattr(model.ell, k).adds_dense)
              for k in DIRECTIONS}
    params = dict(model.named_parameters())
    optimizer = ScheduledAdam(lambda c: 1e-2)
    opt_state = optimizer.init(params)
    step = BUILDERS[builder](model, optimizer, mesh, 1e-4)(params, opt_state)
    gen = torch.Generator(mesh.device).manual_seed(11)
    users, pos, neg = (torch.from_numpy(np.array(b)).long() for b in batch)
    _, _, loss = step(params, opt_state, users, pos, neg, generator=gen)
    with torch.no_grad():
        whole = {k: (all_gather_rows(p.detach(), mesh) if k.endswith("_emb") else p.detach())
                 for k, p in params.items()}
    return float(loss), whole, blocks


def run_trainer(layout: str, axes, device):
    """3 epochs of the Trainer (the fused Adam update, hash dropout) on a
    ``layout`` model → (losses, canonical parameters, eval metrics, the
    trainer and its state)."""
    data = clustered(64, 96, n_clusters=4, seed=2)
    cfg = ExperimentConfig(
        model=model_cfg(layout, dropout=True, keep_prob=0.6),
        train=TrainConfig(batch_size=64, lr=1e-2, tensorboard=False, fused_adam="pallas",
                          checkpoint_dir=os.devnull),
        eval=EvalConfig(test_batch=32), parallel=ParallelConfig(*axes))
    graph = build_graph(data, edge_pad_multiple=256)
    model = build_model(cfg.model, graph, ell=port_layout(layout, data), device=device)
    tr = Trainer(cfg, data, graph, model, device=device)
    state, losses = tr.init_state(), []
    for _ in range(3):
        state, loss = tr.train_epoch(state)
        losses.append(loss)
    return losses, tr._ckpt_state(state)["params"], tr.evaluate(state), tr, state


def _blocks_rank(device, jparams, batch):
    meshes = {shape: make_mesh(data_axis=shape[0], model_axis=shape[1], device=device)
              for shape in {c[2] for c in CASES}}
    out = {name: port_step(meshes[shape], layout, builder, kw, jparams, batch, control)
           for name, layout, shape, builder, kw, control in CASES}
    out["trainer"] = {layout: run_trainer(layout, (2, 2), device)[:3]
                      for layout in TRAINER_LAYOUTS}
    mesh = meshes[(2, 2)]
    x = torch.tensor([1.0 if mesh.rank == 0 else 2.0**-9], dtype=torch.bfloat16)
    out["bf16_psum"] = psum(mesh, x)[0]
    return out


@pytest.fixture(scope="module")
def jax_side():
    import jax
    import optax

    from gsrs_tpu.config import ModelConfig as JCfg, TrainConfig as JTrain
    from gsrs_tpu.data.adjacency import build_graph as jbuild_graph
    from gsrs_tpu.data.synthetic import clustered as jclustered
    from gsrs_tpu.models.registry import build_model as jbuild
    from gsrs_tpu.ops.hybrid import hybrid_from_interactions as jhybrid
    from gsrs_tpu.ops.sampling import make_sampler_state, sample_triplets
    from gsrs_tpu.ops.tiled import tiled_from_interactions as jtiled
    from gsrs_tpu.train.optim import make_optimizer

    data = jclustered(64, 96, n_clusters=4, seed=1)
    graph = jbuild_graph(data, edge_pad_multiple=256)
    optimizer, _ = make_optimizer(JTrain(lr=1e-2), steps_per_epoch=1)
    batch = sample_triplets(jax.random.key(7), make_sampler_state(data), 64)
    params = None
    refs = {}
    for name, (spmm, cols) in LAYOUTS.items():
        cfg = JCfg(num_layers=2, embedding_dim=8, spmm_mode=spmm, tiled_groups=GROUPS,
                   tiled_cols=cols, hybrid_cols=cols)
        layout = (jtiled(data, groups=GROUPS, cols=cols) if spmm == "tiled"
                  else jhybrid(data, cols=cols))
        model = jbuild(cfg, graph, ell=layout)
        if params is None:
            params = model.init_params(jax.random.key(0))

        def loss_fn(p):
            loss, aux = model.bpr_loss(p, *batch)
            return loss + 1e-4 * aux["reg"]

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, _ = optimizer.update(grads, optimizer.init(params), params)
        new = optax.apply_updates(params, updates)
        refs[name] = (float(loss), {k: np.asarray(v) for k, v in new.items()})
    return dict(jparams={k: np.asarray(v) for k, v in params.items()}, refs=refs,
                batch=tuple(np.asarray(b) for b in batch))


@pytest.fixture(scope="module")
def ranks(jax_side):
    return spawn(_blocks_rank, 4, jax_side["jparams"], jax_side["batch"], device_type="cpu",
                 timeout_s=300)


def params_err(got, want_jax, layout) -> float:
    want = params_from_jax(want_jax, model_cfg(layout), "cpu")
    assert set(got) == set(want)
    return max(float((got[k] - v).abs().max()) for k, v in want.items())


@pytest.mark.parametrize("name", [c[0] for c in CASES if not c[5] and not c[4]])
def test_sharded_blocks_step_matches_jax_single_device(ranks, jax_side, name):
    layout = next(c[1] for c in CASES if c[0] == name)
    ref_loss, ref_params = jax_side["refs"][layout]
    for out in ranks:
        loss, params, _ = out[name]
        np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL)
        assert params_err(params, ref_params, layout) <= PARAM_ATOL


@pytest.mark.parametrize("layout", ["tiled_c10", "hybrid_c10"])
def test_a_whole_block_counted_on_every_rank_fails_the_limits(ranks, jax_side, layout):
    ref_loss, ref_params = jax_side["refs"][layout]
    loss, params, _ = ranks[0][f"{layout}-control"]
    assert (abs(loss / ref_loss - 1) > LOSS_RTOL
            or params_err(params, ref_params, layout) > PARAM_ATOL)


@pytest.mark.parametrize("layout", ["tiled", "hybrid", "tiled_c10", "hybrid_c10"])
def test_sharded_dropout_step_matches_the_one_card_step(ranks, jax_side, layout):
    """Column shards mask their own columns; where C does not divide, only
    rank 0 masks (and adds) the whole block."""
    loss, params, _ = port_step(single_device_mesh("cpu"), layout, "gspmd", DROPOUT,
                                jax_side["jparams"], jax_side["batch"])
    assert params_err(params, jax_side["refs"][layout][1], layout) > 100 * PARAM_ATOL  # dropped
    for out in ranks:
        got_loss, got, _ = out[f"{layout}-dropout"]
        np.testing.assert_allclose(got_loss, loss, rtol=LOSS_RTOL)
        for k, v in params.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=PARAM_ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("name", ["tiled-2x2", "hybrid-2x2", "tiled_c10", "hybrid_c10"])
def test_each_rank_holds_its_columns_or_the_whole_block_once(ranks, name):
    """C/size columns of every dense block a rank where C divides by the
    mesh size; the whole block on every rank, added by rank 0 alone, where
    it does not."""
    layout = next(c[1] for c in CASES if c[0] == name)
    spmm, cols = LAYOUTS[layout]
    rows = {"user_from_item": 64, "item_from_user": 96}
    for r, out in enumerate(ranks):
        for k, (shape, adds) in out[name][2].items():
            n_rows = -(-rows[k] // GROUPS) * GROUPS if spmm == "tiled" else rows[k]
            if cols % 4:
                assert shape == (n_rows, cols) and adds == (r == 0)
            else:
                assert shape == (n_rows, cols // 4) and adds


@pytest.mark.parametrize("layout", TRAINER_LAYOUTS)
def test_trainer_on_mesh_matches_the_one_card_trainer(ranks, layout):
    """The Trainer's mesh path shards the layout (`place_model`), where the
    JAX Trainer replicates it: 3 epochs with hash dropout and the fused
    Adam update equal the one-card Trainer's (losses rtol 1e-5,
    parameters atol 1e-5), and the mesh's eval equals the one card's eval
    of the same parameters (within 1e-6: after training, near-tied scores
    may swap under 1e-7 parameter differences)."""
    losses, params, _, tr, state = run_trainer(layout, (1, 1), "cpu")
    got_losses, got, got_metrics = ranks[0]["trainer"][layout]
    np.testing.assert_allclose(got_losses, losses, rtol=LOSS_RTOL)
    for k, v in params.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=PARAM_ATOL, err_msg=k)
    assert all(out["trainer"][layout][2] == got_metrics for out in ranks)
    tr.model.load_state_dict(got)
    metrics = tr.evaluate(state)
    assert metrics["recall@20"] > 0
    for k, v in metrics.items():
        assert abs(got_metrics[k] - v) <= METRIC_ATOL, (k, got_metrics[k], v)


def test_psum_sums_bf16_partials_in_fp32_and_rounds_once(ranks):
    """1 + 3 · 2^-9: bf16 sums in rank order would round each add back
    to 1; the fp32 sum rounds once, to 1 + 2^-7."""
    for out in ranks:
        assert out["bf16_psum"].dtype == torch.bfloat16
        assert float(out["bf16_psum"]) == 1.0 + 2.0**-7


def test_shard_map_step_still_refuses_hybrid(jax_side):
    model = port_model("hybrid", {}, jax_side["jparams"], "cpu")
    with pytest.raises(ValueError, match="hybrid"):
        make_shard_map_train_step(model, ScheduledAdam(lambda c: 1e-2),
                                  single_device_mesh("cpu"), 1e-4)
