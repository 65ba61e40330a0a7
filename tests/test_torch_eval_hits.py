"""The graph eval checks on a trained run that hits, on the CPU.

`chip_smoke.py`'s hits phase trains LightGCN on a clustered set (each
test item an unseen item of the user's cluster), where a trained model
ranks far above chance, and holds the card's eval checks on that run.
Here the same checks run at a small size (600 users × 1,200 items, 24
clusters; the port's CLI at the smoke's width, 3 layers of 64, which
`bench_eval`'s model needs; 32 steps at lr 5e-2):

- (a) the port's `Evaluator` equals JAX's on the same parameters, carried
  across by `convert.params_from_jax`, in the natural and the bit-plane
  branch (JAX's bit-plane kernel in interpret mode), within 1e-6, and
  recall@20 is at least the smoke's floor (`HITS_FLOOR_VS_CHANCE` times
  `chance_recall`);
- (b) `bench_eval`'s exact, natural and bit-plane rows are equal and at
  least that floor;
- (c) `eval_checkpoint` reproduces the run's last CSV row, which is at
  least that floor;
- (d) the random-item control (`random_test_split`) reads below it.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest

from gsrs_tpu_torch import cli
from gsrs_tpu_torch.config import EvalConfig, ModelConfig
from gsrs_tpu_torch.convert import params_from_jax
from gsrs_tpu_torch.data import synthetic
from gsrs_tpu_torch.data.adjacency import build_graph
from gsrs_tpu_torch.models.registry import build_model
from gsrs_tpu_torch.ops.ell import ell_from_interactions
from gsrs_tpu_torch.tools import bench_eval, eval_checkpoint
from gsrs_tpu_torch.train.evaluator import Evaluator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
ATOL = 1e-6  # float32 sums of 0/1 labels and log2 discounts (tests/test_torch_evaluator.py)
K = 20
NAME = "hits_small"
SHAPE = dict(n_users=600, m_items=1200, n_clusters=24, in_cluster_p=0.2, cross_cluster_p=0.002)
MODEL = dict(num_layers=3, embedding_dim=64)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The CLI's run on the small clustered set → (data root, checkpoint
    directory, the loaded data, the trained parameters, the floor)."""
    root = str(tmp_path_factory.mktemp("hits"))
    SMOKE.write_cli_dataset(synthetic.clustered(**SHAPE, seed=SMOKE.SEED),
                            os.path.join(root, NAME))
    ckpt = os.path.join(root, "ckpt")
    trainer, state = cli.main(
        ["--data_root", root, "--dataset", NAME, "--model", "lgn", "--spmm", "ell", "--recdim",
         "64", "--layer", "3", "--bpr_batch", "2048", "--lr", "5e-2", "--epochs", "8",
         "--eval_every", "1", "--topk_method", "exact", "--fused_adam", "pallas",
         "--tensorboard", "0", "--checkpoint_dir", ckpt], device=CPU)
    assert state.epoch == 8 and 8 * trainer.steps_per_epoch == 32
    params = {k: v.detach().numpy().copy() for k, v in trainer.model.state_dict().items()}
    floor = SMOKE.HITS_FLOOR_VS_CHANCE * SMOKE.chance_recall(trainer.data, K)
    return root, ckpt, trainer.data, params, floor


def _port_model(data, params):
    model = build_model(ModelConfig(**MODEL), build_graph(data, 256),
                        ell=ell_from_interactions(data), device=CPU)
    model.load_state_dict(params_from_jax(params, model.cfg, CPU))
    return model


def test_chance_recall_is_the_mean_of_k_over_unseen_items():
    data = synthetic.clustered(40, 70, n_clusters=3, seed=5)
    want = np.mean([K / (data.m_items - data.positives_of(u).size) for u in data.test_dict])
    assert SMOKE.chance_recall(data, K) == pytest.approx(want, rel=1e-12)


def test_random_test_split_draws_one_unseen_item_a_user_by_seed():
    data = synthetic.clustered(200, 50, n_clusters=2, in_cluster_p=0.5, seed=6)  # dense rows
    control = SMOKE.random_test_split(data, seed=7)
    assert list(control.test_dict) == list(data.test_users())
    for u, items in control.test_dict.items():
        assert items.dtype == np.int64 and items.shape == (1,)
        assert items[0] not in data.positives_of(u)
    again = SMOKE.random_test_split(data, seed=7)
    assert all(np.array_equal(again.test_dict[u], v) for u, v in control.test_dict.items())
    assert data.test_dict is not control.test_dict  # the data's own split is left as it was


@pytest.mark.parametrize("use_pallas_scoring", ["off", "on"])
def test_evaluator_matches_jax_above_the_floor(run, monkeypatch, use_pallas_scoring):
    jax = pytest.importorskip("jax", reason="the JAX package is the reference")
    import jax.numpy as jnp

    from gsrs_tpu.config import EvalConfig as JEval, ModelConfig as JModel
    from gsrs_tpu.data.adjacency import build_graph as jgraph
    from gsrs_tpu.data.dataset import load_dataset as jload
    from gsrs_tpu.models.registry import build_model as jbuild
    from gsrs_tpu.ops import pallas_kernels as pk
    from gsrs_tpu.ops.ell import ell_from_interactions as jell
    from gsrs_tpu.train.evaluator import Evaluator as JEvaluator

    # the JAX bit-plane kernel runs on the CPU only in interpret mode
    monkeypatch.setattr(pk, "masked_scores_bitplane_pallas", functools.partial(
        pk.masked_scores_bitplane_pallas, block_b=8, interpret=True))
    root, _, data, params, floor = run
    ekw = dict(test_batch=256, topks=(K,), use_pallas_scoring=use_pallas_scoring)
    jd = jload(os.path.join(root, NAME), name=NAME)
    jm = jbuild(JModel(**MODEL), jgraph(jd, 256), ell=jell(jd))
    want = JEvaluator(jd, jm, JEval(**ekw)).run({k: jnp.asarray(v) for k, v in params.items()})
    ev = Evaluator(data, _port_model(data, params), EvalConfig(**ekw), device=CPU)
    assert ev._bitplane == (use_pallas_scoring == "on")
    got = ev.run()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), atol=ATOL, err_msg=k)
    assert got[f"recall@{K}"] >= floor


def test_bench_eval_rows_agree_above_the_floor(run, capsys):
    root, ckpt, _, _, floor = run
    rows = bench_eval.main(["--dataset_dir", os.path.join(root, NAME), "--checkpoint_dir", ckpt,
                            "--skip_scale", "--device", CPU])
    assert "restored" in capsys.readouterr().out
    by = {r["variant"]: r for r in rows}
    assert set(by) == {"auto", "exact", "approx", "pallas-bitplane+exact", "pallas-natural+exact"}
    for v in ("pallas-natural+exact", "pallas-bitplane+exact"):
        for k in ("recall@20", "ndcg@20"):
            assert abs(by[v][k] - by["exact"][k]) <= ATOL, (v, k)
    for v in ("exact", "pallas-natural+exact", "pallas-bitplane+exact"):
        assert by[v]["recall@20"] >= floor, by[v]


def test_eval_checkpoint_reproduces_the_runs_last_row(run):
    root, ckpt, _, _, floor = run
    metrics = eval_checkpoint.main(["--checkpoint_dir", ckpt, "--data_root", root, "--dataset",
                                    NAME, "--device", CPU])
    last = SMOKE.csv_rows(os.path.join(ckpt, "valid_epoch_metrics.csv"))[-1]
    assert last["epoch"] == "8"
    want = {k: float(v) for k, v in last.items() if "@" in k}
    assert set(metrics) == set(want)
    for k in want:
        assert abs(metrics[k] - want[k]) <= ATOL, k
    assert want[f"recall@{K}"] >= floor


def test_random_item_control_reads_below_the_floor(run):
    root, _, data, params, floor = run
    model = _port_model(data, params)
    trained = Evaluator(data, model, EvalConfig(topks=(K,)), device=CPU).run()
    control = Evaluator(SMOKE.random_test_split(data, seed=SMOKE.SEED + 1), model,
                        EvalConfig(topks=(K,)), device=CPU).run()
    assert trained[f"recall@{K}"] >= floor > control[f"recall@{K}"]
