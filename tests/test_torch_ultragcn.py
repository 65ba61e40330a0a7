"""The port's UltraGCN (`gsrs_tpu_torch.models.ultragcn`) against the JAX
package's on JAX-CPU: `real_edges` and `build_ii_constraint` (with and
without ``diag_zero``, at an odd block size) array for array, and an
item–item cache written by either package read by the other; every
``ug_neg_sharing`` mode's loss and gradients, with ``ug_sift_pos`` under
``full`` and ``pool``, equal to JAX's when the port is handed the draws
JAX makes for the same key (fp32 within rtol 1e-5, atol 1e-6: sums in
another order); the validation errors; the step generator's draws; and
the Trainer's by-edge pairs and train bitset."""

import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="the JAX package is the reference these tests compare with")

import jax
import jax.numpy as jnp

from gsrs_tpu.config import ModelConfig as JModelConfig
from gsrs_tpu.data.adjacency import build_graph as jbuild_graph
from gsrs_tpu.data.synthetic import clustered as jclustered
from gsrs_tpu.models import ultragcn as jug
from gsrs_tpu.ops.bitset import build_bitset as jbuild_bitset
from gsrs_tpu_torch.config import ModelConfig
from gsrs_tpu_torch.convert import params_from_jax
from gsrs_tpu_torch.data import adjacency as tadj
from gsrs_tpu_torch.data import synthetic as tsyn
from gsrs_tpu_torch.models import ultragcn as tug
from gsrs_tpu_torch.ops.bitset import bitset_to_tensor, build_bitset

RTOL, ATOL = 1e-5, 1e-6
CPU = "cpu"
N, M = 48, 72


def _setup(seed=5):
    jd = jclustered(N, M, n_clusters=4, seed=seed)
    td = tsyn.clustered(N, M, n_clusters=4, seed=seed)
    return jd, td, jbuild_graph(jd, 256), tadj.build_graph(td, 256)


def test_real_edges_match_jax():
    jd, td, jg, tg = _setup()
    for a, b in zip(tug.real_edges(tg), jug.real_edges(jg)):
        np.testing.assert_array_equal(a, b)
    assert set(zip(*(a.tolist() for a in tug.real_edges(tg)))) == set(
        zip(td.train_users.tolist(), td.train_items.tolist()))


@pytest.mark.parametrize("diag_zero", [False, True])
@pytest.mark.parametrize("block", [7, 4096])
def test_ii_constraint_is_the_jax_constraint(diag_zero, block):
    _, _, jg, tg = _setup()
    got = tug.build_ii_constraint(tg, 5, diag_zero=diag_zero, block=block)
    want = jug.build_ii_constraint(jg, 5, diag_zero=diag_zero, block=block)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == (M, 5)
        np.testing.assert_array_equal(a, b)
    if diag_zero:
        assert not (got[0] == np.arange(M)[:, None])[got[1] > 0].any()


def _mark(path: str):
    """Shift the cached weights by 1, keys and checksum kept, so a read
    of the cache is told apart from a rebuild."""
    with np.load(path) as z:
        arrays = dict(z)
    arrays["weights"] = arrays["weights"] + 1.0
    np.savez(path, **arrays)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ii_cache_written_by_one_package_is_read_by_the_other(tmp_path, writer):
    _, _, jg, tg = _setup()
    build = {"jax": (jug.build_ii_constraint, jg), "port": (tug.build_ii_constraint, tg)}
    reader = "port" if writer == "jax" else "jax"
    fn, g = build[writer]
    nbrs, w = fn(g, 4, cache_dir=str(tmp_path))
    path = tmp_path / tug.II_CACHE_NAME
    assert tug.II_CACHE_NAME == jug.II_CACHE_NAME and path.exists()
    _mark(str(path))
    fn, g = build[reader]
    n2, w2 = fn(g, 4, cache_dir=str(tmp_path))
    np.testing.assert_array_equal(n2, nbrs)
    np.testing.assert_array_equal(w2, w + 1.0)
    n3, _ = fn(g, 6, cache_dir=str(tmp_path))  # another K misses the cache
    assert n3.shape == (M, 6)


def _cfg(**kw):
    base = dict(model="ultragcn", embedding_dim=8, ug_neg_num=16, ug_neg_groups=2,
                ug_neg_pool=32, ug_lambda=1.0, ug_ii_k=4, ug_init_std=0.1)
    base.update(kw)
    return base


def _jax_draws(cfg: dict, key, B: int):
    """The draws JAX's `UltraGCN.bpr_loss` makes from ``key``, as the
    port's `draw_negatives` returns them."""
    mode, N_, m = cfg["ug_neg_sharing"], cfg["ug_neg_num"], M
    if mode == "full":
        return {}
    if mode == "pool":
        P = cfg["ug_neg_pool"]
        k_pool, k_inc = jax.random.split(key)
        return {"pool": torch.from_numpy(np.array(jax.random.randint(k_pool, (P,), 0, m))).long(),
                "include": torch.from_numpy(np.array(jax.random.bernoulli(
                    k_inc, min(N_ / P, 1.0), (B, P))))}
    shape = {"none": (B, N_), "batch": (N_,), "group": (cfg["ug_neg_groups"], N_)}[mode]
    return {"negs": torch.from_numpy(np.array(jax.random.randint(key, shape, 0, m))).long()}


@pytest.mark.parametrize("mode,sift", [("none", False), ("batch", False), ("group", False),
                                       ("full", False), ("pool", False), ("full", True),
                                       ("pool", True)])
def test_loss_and_gradients_match_jax_given_its_draws(mode, sift):
    jd, td, jg, tg = _setup()
    kw = _cfg(ug_neg_sharing=mode, ug_sift_pos=sift)
    jm = jug.UltraGCN(JModelConfig(**kw), jg)
    params = jm.init_params(jax.random.key(3))
    tm = tug.UltraGCN(ModelConfig(**kw), tg, device=CPU)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tm.cfg, CPU))
    jbits = jug.TrainBitset(jnp.asarray(jbuild_bitset(jd.train_users, jd.train_items, N, M)))
    tm.train_bitset = bitset_to_tensor(build_bitset(td.train_users, td.train_items, N, M), CPU)
    rng = np.random.default_rng(6)
    B = 8
    users, pos = rng.integers(0, N, B), rng.integers(0, M, B)
    key = jax.random.key(7)
    decay = 1e-3

    def jloss(p):
        loss, aux = jm.bpr_loss(p, jnp.asarray(users), jnp.asarray(pos), jnp.asarray(pos),
                                dropout_key=key, ell=jbits if sift else None)
        return loss + decay * aux["reg"], aux

    (jval, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    loss, aux = tm.objective(torch.from_numpy(users), torch.from_numpy(pos),
                             _jax_draws(kw, key, B))
    total = loss + decay * aux["reg"]
    total.backward()
    assert set(aux) == set(jaux) == {"bpr", "ii", "reg"}
    for k in aux:
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]), rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(jval), rtol=RTOL)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tm.cfg, CPU)
    for name, p in tm.named_parameters():
        scale = float(want[name].abs().max())
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=RTOL,
                                   atol=ATOL * max(scale, 1.0), err_msg=name)


def test_validation_errors():
    _, _, _, tg = _setup()
    with pytest.raises(ValueError, match="sift_pos requires"):
        tug.UltraGCN(ModelConfig(**_cfg(ug_neg_sharing="batch", ug_sift_pos=True)), tg, device=CPU)
    with pytest.raises(ValueError, match="ug_neg_sharing must be"):
        tug.UltraGCN(ModelConfig(**_cfg(ug_neg_sharing="nope")), tg, device=CPU)
    with pytest.raises(ValueError, match="ug_neg_pool"):
        tug.UltraGCN(ModelConfig(**_cfg(ug_neg_sharing="pool", ug_neg_pool=0)), tg, device=CPU)
    with pytest.raises(ValueError, match="ug_neg_groups"):
        tug.UltraGCN(ModelConfig(**_cfg(ug_neg_sharing="group", ug_neg_groups=0)), tg,
                     device=CPU)
    model = tug.UltraGCN(ModelConfig(**_cfg(ug_neg_sharing="full", ug_sift_pos=True)), tg,
                         device=CPU)
    u = torch.tensor([0, 1])
    with pytest.raises(ValueError, match="train bitset"):
        model.bpr_loss(u, u, u, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="step generator"):
        model.bpr_loss(u, u, u)
    group = tug.UltraGCN(ModelConfig(**_cfg(ug_neg_sharing="group", ug_neg_groups=3)), tg,
                         device=CPU)
    with pytest.raises(ValueError, match="not divisible"):
        group.bpr_loss(u, u, u, torch.Generator().manual_seed(0))


def test_draws_are_the_step_generators_and_the_eval_surface_has_no_layers():
    _, _, _, tg = _setup()
    shapes = {"none": {"negs": (8, 16)}, "batch": {"negs": (16,)}, "group": {"negs": (2, 16)},
              "pool": {"pool": (32,), "include": (8, 32)}, "full": {}}
    for mode, want in shapes.items():
        model = tug.UltraGCN(ModelConfig(**_cfg(ug_neg_sharing=mode)), tg, device=CPU)
        a = model.draw_negatives(torch.Generator().manual_seed(1), 8)
        b = model.draw_negatives(torch.Generator().manual_seed(1), 8)
        assert {k: tuple(v.shape) for k, v in a.items()} == want
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert all(int(v.max()) < M for k, v in a.items() if k != "include")
    assert model.ell is None and model.cfg.num_layers == 0 and not model._ii_built
    users = torch.tensor([0, 3])
    with torch.no_grad():
        want = model.user_emb[users] @ model.item_emb.T
        torch.testing.assert_close(model.users_rating(users), want, rtol=0, atol=0)
    assert model.ii_neighbors is None  # built at the first loss only
    assert abs(float(model.user_emb.detach().std()) - 0.1) < 0.02  # N(0, ug_init_std²)


def test_trainer_samples_pairs_by_edge_and_hands_over_its_bitset(tmp_path):
    """The Trainer gives UltraGCN the sampler's bitset (``ug_sift_pos``),
    a step generator every step, and (user, pos) pairs drawn uniformly
    over the interactions, so users come ∝ their degree; the loss falls
    over four epochs."""
    from gsrs_tpu_torch.config import ExperimentConfig, TrainConfig
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.ops.sampling import sample_epoch
    from gsrs_tpu_torch.train.trainer import Trainer

    data = tsyn.clustered(48, 64, n_clusters=4, seed=5)
    graph = tadj.build_graph(data, 256)
    cfg = ExperimentConfig(
        model=ModelConfig(model="ultragcn", embedding_dim=8, ug_neg_sharing="full",
                          ug_sift_pos=True, ug_ii_k=4),
        train=TrainConfig(batch_size=64, lr=1e-2))
    model = build_model(cfg.model, graph, device=CPU, cache_dir=str(tmp_path))
    tr = Trainer(cfg, data, graph, model, run_eval=False, device=CPU)
    assert model.train_bitset is tr.sampler_state.train_bitset
    state = tr.init_state()
    losses = []
    for _ in range(4):
        state, loss = tr.train_epoch(state)
        losses.append(loss)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert os.path.exists(tmp_path / tug.II_CACHE_NAME)
    S = 20000
    u, p, _ = sample_epoch(torch.Generator().manual_seed(0), tr.sampler_state, S, S,
                           by_edge=True)
    u, p = u.reshape(-1).numpy(), p.reshape(-1).numpy()
    edges = set(zip(data.train_users.tolist(), data.train_items.tolist()))
    assert all((a, b) in edges for a, b in zip(u[:500].tolist(), p[:500].tolist()))
    counts = np.bincount(u, minlength=data.n_users)
    expect = data.user_degrees / data.user_degrees.sum() * S
    assert np.all(np.abs(counts - expect) < 4 * np.sqrt(np.maximum(expect, 1)) + 10)
