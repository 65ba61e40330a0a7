"""The graph family on a (data, model) mesh of gloo ranks spawned on the
CPU (`gsrs_tpu_torch.parallel`), against the JAX package on one device.

The children import no JAX: the parent computes JAX's results and hands
its numbers down (parameters, batches). As `tests/test_distributed.py`
holds the JAX mesh to its single device, the port's mesh is held to
JAX's single-device step within JAX's own limits (losses rtol 1e-5,
parameters atol 1e-5): both step builders (`make_train_step`,
`make_shard_map_train_step`), at mesh shapes (1, 4), (2, 2) and (4, 1),
on the ELL and segment layouts; and at (2, 2) with the pop gate, i2i
smoothing, ``reg_mode`` "ego" and the fused Adam update (its kernel's
plain version on the CPU) against plain Adam. Edge dropout draws its
mask from a torch generator, which JAX cannot reproduce, so the mesh's
dropout step is held to the port's own 1 × 1 step with the same
generator, within the same limits. The sharded eval top-k gives JAX's
unsharded ids and values (within 1e-5). The Trainer on a 2 × 2 mesh
equals the single-card Trainer (losses rtol 1e-5, parameters atol 1e-5,
and the same eval metrics, within 1e-6, on the same parameters: after
training, near-tied scores of the clustered set may swap under 1e-7
parameter differences). The CLI trains on a padded mesh, its checkpoint
(canonical, the real rows) resumes on one card, and the card's resumes
on the mesh. `dryrun_multichip` runs on four ranks."""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gsrs_tpu_torch import cli
from gsrs_tpu_torch.config import (
    EvalConfig, ExperimentConfig, ModelConfig, ParallelConfig, TrainConfig,
)
from gsrs_tpu_torch.convert import params_from_jax
from gsrs_tpu_torch.data.adjacency import build_graph
from gsrs_tpu_torch.data.dataset import write_interaction_file
from gsrs_tpu_torch.data.synthetic import clustered
from gsrs_tpu_torch.models.lightgcn import ItemItemGraph
from gsrs_tpu_torch.models.registry import build_model
from gsrs_tpu_torch.ops.ell import ell_from_interactions
from gsrs_tpu_torch.parallel.collectives import all_gather_rows
from gsrs_tpu_torch.parallel.dist_train import make_eval_scores_fn, make_train_step
from gsrs_tpu_torch.parallel.dryrun import dryrun_multichip
from gsrs_tpu_torch.parallel.launch import spawn
from gsrs_tpu_torch.parallel.mesh import make_mesh, single_device_mesh
from gsrs_tpu_torch.parallel.shard_map_train import make_shard_map_train_step
from gsrs_tpu_torch.parallel.sharding import GraphShardings
from gsrs_tpu_torch.train.fused_adam import FusedAdam
from gsrs_tpu_torch.train.optim import ScheduledAdam
from gsrs_tpu_torch.train.trainer import Trainer

LOSS_RTOL, PARAM_ATOL, SCORE_ATOL, METRIC_ATOL = 1e-5, 1e-5, 1e-5, 1e-6
SHAPES = [(1, 4), (2, 2), (4, 1)]
BUILDERS = {"gspmd": make_train_step, "shard_map": make_shard_map_train_step}
VARIANTS = {  # (2, 2) runs: ModelConfig fields, optimizer
    "pop_gate": (dict(use_pop_gate=True), "adam"),
    "i2i": (dict(use_item_item=True, i2i_alpha=0.3), "adam"),
    "ego": (dict(reg_mode="ego"), "adam"),
    "fused": ({}, "fused"),
    "dropout": (dict(dropout=True, keep_prob=0.6), "adam"),
}
CLI_DATA = (61, 97)  # odd: a model axis of 2 pads both


def cases():
    out = [(f"{b}-{spmm}-{d}x{m}", (d, m), b, dict(spmm_mode=spmm), "adam")
           for b in BUILDERS for spmm in ("ell", "segment") for d, m in SHAPES]
    out += [(name, (2, 2), "gspmd", kw, opt) for name, (kw, opt) in VARIANTS.items()]
    return out


def i2i_matrix():
    rng = np.random.default_rng(5)
    a = sp.random(96, 96, density=0.05, random_state=rng, format="csr", dtype=np.float32)
    a = a + a.T
    return sp.csr_matrix(a / max(a.sum(1).max(), 1.0))


def port_model(cfg_kw, jparams, device):
    data = clustered(64, 96, n_clusters=4, seed=1)
    cfg = ModelConfig(num_layers=2, embedding_dim=8, **cfg_kw)
    i2i = ItemItemGraph.from_scipy(i2i_matrix()) if cfg.use_item_item else None
    model = build_model(cfg, build_graph(data, edge_pad_multiple=256), i2i,
                        ell_from_interactions(data), device=device)
    model.load_state_dict(params_from_jax(jparams, cfg, device))
    return model


def port_step(mesh, builder, cfg_kw, opt, jparams, batch):
    """One step of ``builder`` on ``mesh`` from JAX's parameters → (loss,
    the whole updated parameters)."""
    model = port_model(cfg_kw, jparams, mesh.device)
    sh = GraphShardings(mesh)
    sh.place_model(model)
    params = dict(model.named_parameters())
    optimizer = (FusedAdam(lambda c: 1e-2, backend="pallas") if opt == "fused"
                 else ScheduledAdam(lambda c: 1e-2))
    opt_state = optimizer.init(params)
    step = BUILDERS[builder](model, optimizer, mesh, 1e-4)(params, opt_state)
    gen = torch.Generator(mesh.device).manual_seed(11)
    users, pos, neg = (torch.from_numpy(np.array(b)).long() for b in batch)
    _, _, loss = step(params, opt_state, users, pos, neg, generator=gen)
    with torch.no_grad():
        whole = {k: (all_gather_rows(p.detach(), mesh) if k.endswith("_emb") else p.detach())
                 for k, p in params.items()}
    return float(loss), whole


def trainer_cfg(axes):
    return ExperimentConfig(
        model=ModelConfig(num_layers=2, embedding_dim=8, use_pop_gate=True),
        train=TrainConfig(batch_size=64, lr=1e-2, tensorboard=False, fused_adam="pallas",
                          checkpoint_dir=os.devnull),
        eval=EvalConfig(test_batch=32), parallel=ParallelConfig(*axes))


def run_trainer(axes, device):
    data = clustered(64, 96, n_clusters=4, seed=2)
    cfg = trainer_cfg(axes)
    graph = build_graph(data, edge_pad_multiple=256)
    tr = Trainer(cfg, data, graph, build_model(cfg.model, graph, ell=ell_from_interactions(data),
                                               device=device), device=device)
    state, losses = tr.init_state(), []
    for _ in range(3):
        state, loss = tr.train_epoch(state)
        losses.append(loss)
    return tr, state, losses


def cli_argv(root, ckpt, epochs, axes=None, resume=False):
    argv = ["--data_root", root, "--dataset", "ds", "--layer", "2", "--recdim", "8",
            "--bpr_batch", "32", "--epochs", str(epochs), "--eval_every", "1", "--testbatch",
            "16", "--checkpoint_dir", ckpt, "--tensorboard", "0", "--use_pop_gate",
            "--fused_adam", "pallas", "--topks", "[5]"]
    if axes:
        argv += ["--data_axis", str(axes[0]), "--model_axis", str(axes[1])]
    return argv + (["--resume"] if resume else [])


def _mesh_rank(device, jparams, batch, eval_in, cli_root):
    out = {"steps": {}}
    meshes = {shape: make_mesh(data_axis=shape[0], model_axis=shape[1], device=device)
              for shape in SHAPES}
    for name, shape, builder, cfg_kw, opt in cases():
        out["steps"][name] = port_step(meshes[shape], builder, cfg_kw, opt,
                                       jparams[name.split("-")[0] if name in VARIANTS
                                               else "base"], batch)
    mesh = meshes[(2, 2)]
    model = port_model({}, jparams["base"], device)
    GraphShardings(mesh).place_model(model)
    with torch.no_grad():
        all_users, items, _ = GraphShardings(mesh).call(model, "final_embeddings")
    users, rows = (torch.from_numpy(a) for a in eval_in)
    out["eval"] = make_eval_scores_fn(model, mesh)(all_users, items, users.long(), rows, 10)
    tr, state, losses = run_trainer((2, 2), device)
    out["trainer"] = (losses, tr._ckpt_state(state)["params"], tr.evaluate(state))
    trainer, state = cli.main(cli_argv(cli_root, os.path.join(cli_root, "ck"), 2, (2, 2)),
                              device=device)
    out["cli"] = (trainer.data.n_users, trainer.data.m_items, state.epoch)
    return out


def _resume_rank(device, cli_root):
    trainer, state = cli.main(cli_argv(cli_root, os.path.join(cli_root, "ck"), 4, (2, 2),
                                       resume=True), device=device)
    return state.epoch, trainer._ckpt_state(state)["params"]


@pytest.fixture(scope="module")
def jax_side():
    import jax
    import jax.numpy as jnp
    import optax

    from gsrs_tpu.config import ModelConfig as JCfg, TrainConfig as JTrain
    from gsrs_tpu.data.adjacency import build_graph as jbuild_graph
    from gsrs_tpu.data.synthetic import clustered as jclustered
    from gsrs_tpu.models.lightgcn import ItemItemGraph as JI2I
    from gsrs_tpu.models.registry import build_model as jbuild
    from gsrs_tpu.ops.bitset import build_bitset
    from gsrs_tpu.ops.ell import ell_from_interactions as jell
    from gsrs_tpu.ops.sampling import make_sampler_state, sample_triplets
    from gsrs_tpu.ops.topk import masked_topk
    from gsrs_tpu.train.optim import make_optimizer

    data = jclustered(64, 96, n_clusters=4, seed=1)
    graph = jbuild_graph(data, edge_pad_multiple=256)
    optimizer, _ = make_optimizer(JTrain(lr=1e-2), steps_per_epoch=1)
    batch = sample_triplets(jax.random.key(7), make_sampler_state(data), 64)

    def step(cfg_kw):
        cfg = JCfg(num_layers=2, embedding_dim=8, **cfg_kw)
        i2i = JI2I.from_scipy(i2i_matrix()) if cfg.use_item_item else None
        model = jbuild(cfg, graph, i2i=i2i, ell=jell(data))
        params = model.init_params(jax.random.key(0))

        def loss_fn(p):
            loss, aux = model.bpr_loss(p, *batch)
            return loss + 1e-4 * aux["reg"]

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, _ = optimizer.update(grads, optimizer.init(params), params)
        new = optax.apply_updates(params, updates)
        return ({k: np.asarray(v) for k, v in params.items()}, float(loss),
                {k: np.asarray(v) for k, v in new.items()}, model)

    base_params, base_loss, base_new, model = step({})
    refs, jparams = {"base": (base_loss, base_new)}, {"base": base_params}
    for name, (kw, _) in VARIANTS.items():
        if name in ("fused", "dropout"):
            jparams[name] = base_params
            refs[name] = refs["base"]
            continue
        jparams[name], loss, new, _ = step(kw)
        refs[name] = (loss, new)
    all_users, items, _ = model.final_embeddings(jparams["base"])
    tb = build_bitset(data.train_users, data.train_items, data.n_users, data.m_items)
    users = np.arange(32)
    vals, ids = masked_topk(all_users[users], items, jnp.asarray(tb)[users], 10)
    eval_in = (users.astype(np.int64), tb[users].view(np.int32))
    return dict(jparams=jparams, refs=refs, batch=tuple(np.asarray(b) for b in batch),
                eval_in=eval_in, eval_ref=(np.asarray(vals), np.asarray(ids)))


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    data = clustered(*CLI_DATA, n_clusters=4, seed=3)
    ds = root / "ds"
    ds.mkdir()
    rng = np.random.default_rng(0)
    test = rng.random(data.train_size) < 0.2
    write_interaction_file(str(ds / "train.txt"), data.train_users[~test],
                           data.train_items[~test])
    write_interaction_file(str(ds / "test.txt"), data.train_users[test], data.train_items[test])
    return str(root)


@pytest.fixture(scope="module")
def ranks(jax_side, cli_root):
    return spawn(_mesh_rank, 4, jax_side["jparams"], jax_side["batch"], jax_side["eval_in"],
                 cli_root, device_type="cpu", timeout_s=300)


def assert_params_close(got, want_jax, cfg_kw):
    want = params_from_jax(want_jax, ModelConfig(num_layers=2, embedding_dim=8, **cfg_kw), "cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("name,shape,builder,cfg_kw,opt",
                         [c for c in cases() if c[0] not in VARIANTS])
def test_sharded_step_matches_jax_single_device(ranks, jax_side, name, shape, builder,
                                                cfg_kw, opt):
    ref_loss, ref_params = jax_side["refs"]["base"]
    for r, out in enumerate(ranks):
        loss, params = out["steps"][name]
        np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL)
        if r == 0:
            assert_params_close(params, ref_params, {})


@pytest.mark.parametrize("variant", [v for v in VARIANTS if v != "dropout"])
def test_sharded_step_variants_match_jax(ranks, jax_side, variant):
    ref_loss, ref_params = jax_side["refs"][variant]
    loss, params = ranks[0]["steps"][variant]
    np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL)
    assert_params_close(params, ref_params, VARIANTS[variant][0])


def test_sharded_dropout_step_matches_the_one_card_step(ranks, jax_side):
    kw, opt = VARIANTS["dropout"]
    loss, params = port_step(single_device_mesh("cpu"), "gspmd", kw, opt,
                             jax_side["jparams"]["dropout"], jax_side["batch"])
    got_loss, got = ranks[0]["steps"]["dropout"]
    assert loss != pytest.approx(jax_side["refs"]["base"][0], rel=1e-3)  # edges dropped
    np.testing.assert_allclose(got_loss, loss, rtol=LOSS_RTOL)
    for k, v in params.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


def test_sharded_eval_topk_matches_unsharded_jax(ranks, jax_side):
    vals, ids = jax_side["eval_ref"]
    for r, out in enumerate(ranks):
        got_vals, got_ids = out["eval"]
        part = slice((r // 2) * 16, (r // 2) * 16 + 16)  # the rank's data slice
        np.testing.assert_array_equal(got_ids.numpy(), ids[part])
        np.testing.assert_allclose(got_vals.numpy(), vals[part], rtol=0, atol=SCORE_ATOL)


def test_trainer_on_mesh_matches_single_device(ranks):
    tr, state, losses = run_trainer((1, 1), "cpu")
    mesh_losses, mesh_params, mesh_metrics = ranks[0]["trainer"]
    np.testing.assert_allclose(mesh_losses, losses, rtol=LOSS_RTOL)
    params = tr._ckpt_state(state)["params"]
    for k, v in params.items():
        np.testing.assert_allclose(mesh_params[k].numpy(), v.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    assert all(out["trainer"][2] == mesh_metrics for out in ranks)
    tr.model.load_state_dict(mesh_params)
    metrics = tr.evaluate(state)
    assert metrics["recall@20"] > 0
    for k, v in metrics.items():
        assert abs(mesh_metrics[k] - v) <= METRIC_ATOL, (k, mesh_metrics[k], v)


def test_cli_checkpoints_move_between_mesh_and_one_card(ranks, cli_root):
    assert ranks[0]["cli"] == (62, 98, 2)  # padded to the model axis, 2 epochs
    ckpt = os.path.join(cli_root, "ck")
    saved = torch.load(os.path.join(ckpt, "last", "state.pt"), weights_only=True)
    assert saved["epoch"] == 2 and saved["params"]["user_emb"].shape == (61, 8)
    assert saved["params"]["item_emb"].shape == (97, 8)  # canonical rows
    assert {"train_epoch_metrics.csv", "valid_epoch_metrics.csv",
            "model_meta.json"} <= set(os.listdir(ckpt))
    trainer, state = cli.main(cli_argv(cli_root, ckpt, 3, resume=True), device="cpu")
    assert state.epoch == 3 and trainer.data.n_users == 61
    epoch, params = spawn(_resume_rank, 4, cli_root, device_type="cpu", timeout_s=300)[0]
    assert epoch == 4 and params["item_emb"].shape == (97, 8)
    rows = sum(1 for _ in open(os.path.join(ckpt, "train_epoch_metrics.csv")))
    assert rows == 1 + 4  # header, epochs 1-2 on the mesh, 3 on one card, 4 on the mesh


def test_dryrun_multichip_on_four_ranks():
    out = dryrun_multichip(4, device="cpu")
    assert len(out) == 4 and np.isfinite(out[0]["loss"])
    assert all(o["loss"] == out[0]["loss"] for o in out)
    assert out[0]["top"].shape == (16, 8)


def test_cli_starts_its_own_ranks(cli_root, tmp_path):
    """With no process group to join, ``--data_axis/--model_axis`` start
    the ranks here (gloo on the CPU) and return once they have finished."""
    ckpt = str(tmp_path / "ck")
    assert cli.main(cli_argv(cli_root, ckpt, 1, (1, 2)), device="cpu") is None
    saved = torch.load(os.path.join(ckpt, "last", "state.pt"), weights_only=True)
    assert saved["epoch"] == 1 and saved["params"]["item_emb"].shape == (97, 8)
