"""Item-item smoothing of the port against the JAX package on JAX-CPU:
the offline builder array for array for each scheme, `ItemItemGraph`'s
arrays, the product (`spmm_edges` and the ELL form that runs it, forward
and transposed), `propagate` and the loss's gradients with i2i and the
pop gate from the same parameters (fp32, 1e-5, also on a non-symmetric
matrix), and 3 trainer steps against the JAX trainer's."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gsrs_tpu_torch import config as tcfg
from gsrs_tpu_torch.convert import opt_state_from_jax, params_from_jax
from gsrs_tpu_torch.data import adjacency as tadj
from gsrs_tpu_torch.data import i2i as ti2i
from gsrs_tpu_torch.data import synthetic as tsyn
from gsrs_tpu_torch.models.lightgcn import ItemItemGraph
from gsrs_tpu_torch.models.registry import build_model
from gsrs_tpu_torch.ops.ell import ell_from_interactions, ell_spmm
from gsrs_tpu_torch.ops.spmm import spmm_edges
from gsrs_tpu_torch.train.trainer import Trainer

CPU = "cpu"
ATOL = 1e-5  # fp32 propagation, losses and gradients: summation order only
ADAM_ATOL = 2e-6


@pytest.fixture
def jax():
    return pytest.importorskip("jax", reason="the JAX package is the reference")


def _data():
    from gsrs_tpu.data.synthetic import clustered as jclustered

    return jclustered(120, 160, seed=5), tsyn.clustered(120, 160, seed=5)


def _csr_equal(a, b):
    a, b = a.tocsr(), b.tocsr()
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


@pytest.mark.parametrize("scheme", ["cooc", "jaccard", "ppmi"])
def test_build_item_item_matches_jax(jax, scheme):
    from gsrs_tpu.data import i2i as ji2i

    jd, td = _data()
    _csr_equal(ti2i.cooccurrence_counts(td), ji2i.cooccurrence_counts(jd))
    got, want = ti2i.build_item_item(td, scheme, topk=7), ji2i.build_item_item(jd, scheme, 7)
    _csr_equal(got, want)
    assert got.nnz > 0
    np.testing.assert_allclose((got - got.T).toarray(), 0.0, atol=1e-12)  # symmetrized


def test_i2i_cli_writes_the_npz(tmp_path, jax):
    from gsrs_tpu.data import i2i as ji2i

    from gsrs_tpu_torch.data.dataset import load_dataset, write_interaction_file

    _, td = _data()
    write_interaction_file(str(tmp_path / "train.txt"), td.train_users, td.train_items)
    out = tmp_path / "i2i.npz"
    ti2i.main(["--dataset_dir", str(tmp_path), "--scheme", "ppmi", "--topk", "5",
               "--out", str(out)])
    _csr_equal(sp.load_npz(out), ji2i.build_item_item(load_dataset(str(tmp_path)), "ppmi", 5))
    with pytest.raises(ValueError, match="scheme"):
        ti2i.weight_matrix(ti2i.cooccurrence_counts(td), td.item_degrees, "tfidf")


def _skewed(m, seed=0):
    """A non-symmetric m × m matrix with duplicates-free random entries."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((m, m)) < 0.05) * rng.random((m, m))
    return sp.csr_matrix(dense.astype(np.float64))


@pytest.mark.parametrize("which", ["built", "skewed"])
def test_item_item_graph_matches_jax(jax, which):
    import jax.numpy as jnp

    from gsrs_tpu.models.lightgcn import ItemItemGraph as JItemItemGraph
    from gsrs_tpu.ops.spmm import spmm_edges as jspmm_edges

    _, td = _data()
    mat = ti2i.build_item_item(td, "cooc", 10) if which == "built" else _skewed(160)
    got, want = ItemItemGraph.from_scipy(mat), JItemItemGraph.from_scipy(mat)
    assert got.m_items == want.m_items == 160 and got.n_edges == mat.nnz
    for name in ("dst", "src", "w"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    x = np.random.default_rng(1).standard_normal((160, 16)).astype(np.float32)
    ref = np.asarray(jspmm_edges(want.dst, want.src, want.w, jnp.asarray(x), 160))
    plain = spmm_edges(got.dst, got.src, got.w, torch.from_numpy(x), 160)
    np.testing.assert_allclose(plain.numpy(), ref, atol=ATOL)
    # the ELL form: forward A @ x, backward Aᵀ g (built from the entries)
    xt = torch.from_numpy(x).requires_grad_()
    out = ell_spmm(got.ell, xt)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL)
    g = np.random.default_rng(2).standard_normal((160, 16)).astype(np.float32)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), mat.T.toarray().astype(np.float32) @ g,
                               atol=ATOL)


def _model_pair(jax, mat, use_pop_gate=True, alpha=0.3, reg_mode="propagated"):
    from gsrs_tpu.config import ModelConfig as JModel
    from gsrs_tpu.data.adjacency import build_graph as jgraph
    from gsrs_tpu.models.lightgcn import ItemItemGraph as JItemItemGraph
    from gsrs_tpu.models.registry import build_model as jbuild
    from gsrs_tpu.ops.ell import ell_from_interactions as jell

    jd, td = _data()
    kw = dict(num_layers=2, embedding_dim=16, pop_hidden=8, gate_hidden=16,
              use_pop_gate=use_pop_gate, use_item_item=True, i2i_alpha=alpha,
              reg_mode=reg_mode)
    jm = jbuild(JModel(**kw), jgraph(jd, 256), JItemItemGraph.from_scipy(mat), jell(jd))
    params = jm.init_params(jax.random.key(3))
    tm = build_model(tcfg.ModelConfig(**kw), tadj.build_graph(td, 256),
                     ItemItemGraph.from_scipy(mat), ell_from_interactions(td), device=CPU)
    tm.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in params.items()},
                                       tm.cfg, CPU))
    return jm, params, tm


@pytest.mark.parametrize("which,use_pop_gate,reg_mode", [
    ("built", True, "propagated"), ("built", False, "ego"), ("skewed", True, "propagated"),
])
def test_propagate_and_gradients_match_jax(jax, which, use_pop_gate, reg_mode):
    _, td = _data()
    mat = ti2i.build_item_item(td, "cooc", 10) if which == "built" else _skewed(160, 3)
    jm, params, tm = _model_pair(jax, mat, use_pop_gate, reg_mode=reg_mode)
    ju, ji = jm.propagate(params)
    with torch.no_grad():
        tu, ti = tm.propagate()
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=ATOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=ATOL)
    # the smoothing is there: without it the items differ
    plain = dataclasses.replace(tm.cfg, i2i_alpha=0.0)
    tm.cfg, saved = plain, tm.cfg
    with torch.no_grad():
        assert float((tm.propagate()[1] - ti).abs().max()) > 1e-3
    tm.cfg = saved

    rng = np.random.default_rng(0)
    users, pos, neg = rng.integers(0, 120, 64), rng.integers(0, 160, 64), rng.integers(0, 160, 64)

    def loss_fn(p):
        loss, aux = jm.bpr_loss(p, users, pos, neg)
        return loss + 1e-2 * aux["reg"], (loss, aux)

    (_, (jloss, _)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    loss, aux = tm.bpr_loss(*(torch.from_numpy(a) for a in (users, pos, neg)))
    (loss + 1e-2 * aux["reg"]).backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=ATOL)
    want = params_from_jax({k: np.asarray(v) for k, v in jgrads.items()}, tm.cfg, CPU)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=ATOL, err_msg=name)


def test_model_checks_the_i2i_size():
    _, td = _data()
    with pytest.raises(ValueError, match="i2i graph has 150 items"):
        build_model(tcfg.ModelConfig(embedding_dim=4, use_item_item=True),
                    tadj.build_graph(td, 256), ItemItemGraph.from_scipy(_skewed(150)),
                    device=CPU)
    # without use_item_item the graph is not used
    m = build_model(tcfg.ModelConfig(embedding_dim=4), tadj.build_graph(td, 256),
                    ItemItemGraph.from_scipy(_skewed(160)), device=CPU)
    assert m.i2i is None


@pytest.mark.parametrize("fused", ["off", "pallas"])
def test_run_steps_with_i2i_match_the_jax_trainer(jax, tmp_path, fused):
    """Two JAX steps, the state converted, then three steps on both
    trainers from the same triplets, across an lr milestone."""
    import jax.numpy as jnp

    from gsrs_tpu.config import (
        EvalConfig as JEval, ExperimentConfig as JExp, ModelConfig as JModel,
        TrainConfig as JTrain,
    )
    from gsrs_tpu.data.adjacency import build_graph as jgraph
    from gsrs_tpu.models.lightgcn import ItemItemGraph as JItemItemGraph
    from gsrs_tpu.models.registry import build_model as jbuild
    from gsrs_tpu.ops.ell import ell_from_interactions as jell
    from gsrs_tpu.train.trainer import Trainer as JTrainer

    jd, td = _data()
    mat = ti2i.build_item_item(td, "jaccard", 10)
    B = -(-td.train_size // 3)
    train_kw = dict(batch_size=B, lr=1e-2, decay=1e-3, use_scheduler=True,
                    sched_milestones=(1,), sched_gamma=0.5, fused_adam=fused)
    model_kw = dict(num_layers=2, embedding_dim=16, pop_hidden=8, gate_hidden=16,
                    use_pop_gate=True, use_item_item=True, i2i_alpha=0.25)
    jcfg = JExp(model=JModel(**model_kw),
                train=JTrain(checkpoint_dir=str(tmp_path), tensorboard=False, **train_kw),
                eval=JEval(test_batch=32, topks=(10,)))
    g = jgraph(jd, edge_pad_multiple=256)
    jtr = JTrainer(jcfg, jd, g, jbuild(jcfg.model, g, JItemItemGraph.from_scipy(mat), jell(jd)))
    tcfg_ = tcfg.ExperimentConfig(model=tcfg.ModelConfig(**model_kw),
                                  train=tcfg.TrainConfig(**train_kw),
                                  eval=tcfg.EvalConfig(test_batch=32, topks=(10,)))
    tg = tadj.build_graph(td, edge_pad_multiple=256)
    tm = build_model(tcfg_.model, tg, ItemItemGraph.from_scipy(mat), ell_from_interactions(td),
                     device=CPU)
    ttr = Trainer(tcfg_, td, tg, tm, device=CPU)

    epoch_fn = jtr._build_epoch_fn()
    state = jtr.init_state()
    params, opt_state = state.params, state.opt_state
    rng = np.random.default_rng(9)

    def triplets(n):
        return (rng.integers(0, 120, (n, B)), rng.integers(0, 160, (n, B)),
                rng.integers(0, 160, (n, B)))

    def jax_step(params, opt_state, batch):
        u, p, n = (jnp.asarray(a, jnp.int32) for a in batch)
        keys = jax.random.split(jax.random.key(0), u.shape[0])
        return epoch_fn(params, opt_state, jtr.graph, jtr.model.ell, u, p, n, keys)

    params, opt_state, _ = jax_step(params, opt_state, triplets(2))
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    params_np, opt_np = to_np(params), to_np(opt_state)
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


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gather-reduce kernel is CUDA C++ with no CPU mode")
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_i2i_product_on_the_card_matches_the_cpu(cuda):
    """The i2i product and its transpose through K4 on the card against
    the plain version on the CPU, and the side launch counts."""
    mat = _skewed(3000, 7) / 150  # about 150 entries a row: sums of O(0.1)
    graph = ItemItemGraph.from_scipy(mat)
    x = torch.randn(3000, 64, generator=torch.Generator().manual_seed(0))
    g = torch.randn(3000, 64, generator=torch.Generator().manual_seed(1))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        gr = graph.to(dev)
        xt = x.to(dev).requires_grad_()
        out = ell_spmm(gr.ell, xt)
        out.backward(g.to(dev))
        outs.append((out.detach().cpu(), xt.grad.cpu()))
        if dev.type == "cuda":
            assert gr.ell.by_user.table.launches == 1 and gr.ell.by_item.table.launches == 1
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
