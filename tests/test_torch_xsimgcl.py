"""The port's XSimGCL (`gsrs_tpu_torch.models.xsimgcl`) against the JAX
package's on JAX-CPU: `info_nce` and `info_nce_unique` (duplicate ids
included) with their gradients; the noiseless propagation equal to
LightGCN's, bit for bit; the noisy views, the InfoNCE term and the whole
loss with its gradients equal to JAX's when the port is handed the
uniform draws JAX makes for the same key; the i2i smoothing; and the
step generator's draws, made on the host, equal on every device. fp32
within rtol 1e-5, atol 1e-6: sums of O(1) in another order."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="the JAX package is the reference these tests compare with")

import jax
import jax.numpy as jnp

from gsrs_tpu.config import ModelConfig as JModelConfig
from gsrs_tpu.data.adjacency import build_graph as jbuild_graph
from gsrs_tpu.data.synthetic import clustered as jclustered
from gsrs_tpu.models import xsimgcl as jx
from gsrs_tpu.ops.ell import ell_from_interactions as jell_from_interactions
from gsrs_tpu_torch.config import ModelConfig
from gsrs_tpu_torch.convert import params_from_jax
from gsrs_tpu_torch.data import adjacency as tadj
from gsrs_tpu_torch.data import synthetic as tsyn
from gsrs_tpu_torch.models import xsimgcl as tx
from gsrs_tpu_torch.models.lightgcn import ItemItemGraph, LightGCN
from gsrs_tpu_torch.models.registry import build_model

RTOL, ATOL = 1e-5, 1e-6
CPU = "cpu"
N, M = 64, 96


def _setup(seed=3):
    jd = jclustered(N, M, n_clusters=4, seed=seed)
    td = tsyn.clustered(N, M, n_clusters=4, seed=seed)
    return jd, td, jbuild_graph(jd, 256), tadj.build_graph(td, 256)


def _views(seed=0, n=20, d=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, d)).astype(np.float32) for _ in range(2)]


def _close(got: torch.Tensor, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL,
                               **kw)


def test_info_nce_and_its_gradients_match_jax():
    z1, z2 = _views(1, n=32)
    want, (g1, g2) = jax.value_and_grad(lambda a, b: jx.info_nce(a, b, 0.2), (0, 1))(
        jnp.asarray(z1), jnp.asarray(z2))
    t1, t2 = (torch.from_numpy(z).requires_grad_() for z in (z1, z2))
    got = tx.info_nce(t1, t2, 0.2)
    got.backward()
    _close(got, want)
    _close(t1.grad, g1)
    _close(t2.grad, g2)
    aligned = tx.info_nce(torch.from_numpy(z1), torch.from_numpy(z1 * 1.1), 0.2)
    shuffled = tx.info_nce(torch.from_numpy(z1), torch.from_numpy(z1[::-1].copy() * 1.1), 0.2)
    assert float(aligned) < float(shuffled)


@pytest.mark.parametrize("ids", [[3, 7, 11, 15], [3, 7, 7, 11, 3, 15, 15, 15], [5] * 6])
def test_info_nce_unique_and_its_gradients_match_jax(ids):
    """Duplicate ids count once, in the numerator and the denominator,
    as JAX's sort-and-mask dedup counts them."""
    v1, v2 = _views(2)
    jids = jnp.asarray(ids, jnp.int32)
    want, (g1, g2) = jax.value_and_grad(
        lambda a, b: jx.info_nce_unique(jids, a, b, 0.2), (0, 1))(jnp.asarray(v1), jnp.asarray(v2))
    t1, t2 = (torch.from_numpy(v).requires_grad_() for v in (v1, v2))
    got = tx.info_nce_unique(torch.tensor(ids), t1, t2, 0.2)
    got.backward()
    assert np.isfinite(float(got.detach()))
    _close(got, want)
    _close(t1.grad, g1)
    _close(t2.grad, g2)
    uniq = tx.info_nce_unique(torch.tensor(sorted(set(ids))), torch.from_numpy(v1),
                              torch.from_numpy(v2), 0.2)
    torch.testing.assert_close(got.detach(), uniq, rtol=1e-6, atol=0)


@pytest.mark.parametrize("layout", ["ell", "segment", "hybrid"])
def test_noiseless_propagation_equals_lightgcn(layout):
    _, _, _, tg = _setup()
    kw = dict(num_layers=3, embedding_dim=8, spmm_mode=layout, hybrid_cols=24)
    xs = build_model(ModelConfig(model="xsimgcl", **kw), tg, device=CPU)
    lgn = LightGCN(ModelConfig(**kw), tg, device=CPU)
    lgn.load_state_dict(xs.state_dict())
    with torch.no_grad():
        for a, b in zip(xs.propagate(), lgn.propagate()):
            assert torch.equal(a, b)
        fu, fi, vu, vi = xs.views_from_noise(None, None)
        assert torch.equal(fu, lgn.propagate()[0])


def _jax_noise(key, n_layers, n, m, d):
    """JAX's per-layer U(0, 1) draws (`XSimGCL._propagate_views`)."""
    out = []
    for k in range(n_layers):
        ku, ki = jax.random.split(jax.random.fold_in(key, k))
        out.append(tuple(torch.from_numpy(np.array(jax.random.uniform(kk, shape,
                                                                       dtype=jnp.float32)))
                         for kk, shape in ((ku, (n, d)), (ki, (m, d)))))
    return out


@pytest.mark.parametrize("layout", ["ell", "segment"])
def test_noisy_views_cl_term_and_gradients_match_jax(layout):
    jd, td, jg, tg = _setup()
    kw = dict(model="xsimgcl", num_layers=3, embedding_dim=8, spmm_mode=layout, cl_layer=2,
              cl_lambda=0.2, cl_eps=0.2)
    jm = jx.XSimGCL(JModelConfig(**kw), jg,
                    ell=jell_from_interactions(jd) if layout == "ell" else None)
    params = jm.init_params(jax.random.key(0))
    tm = build_model(ModelConfig(**kw), tg, device=CPU)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tm.cfg, CPU))
    key = jax.random.key(4)
    noise = _jax_noise(key, 3, N, M, 8)

    with torch.no_grad():
        got = tm.views_from_noise(None, noise)
    for g, w in zip(got, jm._propagate_views(params, key)):
        _close(g, w)

    rng = np.random.default_rng(5)
    users, pos, neg = (rng.integers(0, k, 24) for k in (N, M, M))  # duplicates included
    decay = 1e-3

    def jloss(p):
        loss, aux = jm.bpr_loss(p, *(jnp.asarray(a) for a in (users, pos, neg)), key)
        return loss + decay * aux["reg"], aux["cl"]

    (jval, jcl), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    tu, tp, tn = (torch.from_numpy(a) for a in (users, pos, neg))
    loss, aux = tm.loss_from_views(tu, tp, tn, *tm.views_from_noise(None, noise))
    total = loss + decay * aux["reg"]
    total.backward()
    _close(total, jval)
    _close(aux["cl"], jcl)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tm.cfg, CPU)
    for name, p in tm.named_parameters():
        _close(p.grad, want[name].numpy(), err_msg=name)


def test_the_cl_term_needs_the_step_generator():
    _, _, _, tg = _setup()
    model = build_model(ModelConfig(model="xsimgcl", num_layers=2, embedding_dim=8), tg,
                        device=CPU)
    users = torch.arange(16) % N
    pos = torch.arange(16) % M
    neg = (pos + 5) % M
    with torch.no_grad():
        loss0, aux0 = model.bpr_loss(users, pos, neg)
        loss1, aux1 = model.bpr_loss(users, pos, neg, torch.Generator().manual_seed(1))
        again = model.bpr_loss(users, pos, neg, torch.Generator().manual_seed(1))[0]
    assert "cl" not in aux0 and np.isfinite(float(aux1["cl"]))
    assert float(loss0) != float(loss1) and torch.equal(loss1, again)
    noise = model.draw_noise(torch.Generator().manual_seed(2))
    assert [tuple(t.shape) for pair in noise for t in pair] == [(N, 8), (M, 8)] * 2
    assert all(t.device == model.user_emb.device for pair in noise for t in pair)


def test_i2i_smoothing_runs_after_the_layer_mean():
    """``use_item_item``: all_items + α·A @ all_items, through the ELL
    gather-reduce (`ops.ell.ell_spmm`); JAX computes it by `spmm_edges`."""
    from gsrs_tpu.models.lightgcn import ItemItemGraph as JItemItemGraph
    from gsrs_tpu_torch.data.i2i import build_item_item

    jd, td, jg, tg = _setup()
    A = build_item_item(td, scheme="cooc", topk=3)
    kw = dict(model="xsimgcl", num_layers=2, embedding_dim=8)
    with_i2i = build_model(ModelConfig(use_item_item=True, i2i_alpha=0.5, **kw), tg,
                           i2i=ItemItemGraph.from_scipy(A, 64), device=CPU)
    without = build_model(ModelConfig(**kw), tg, device=CPU)
    without.load_state_dict(with_i2i.state_dict())
    with torch.no_grad():
        ai = with_i2i.propagate()[1].numpy()
        ai0 = without.propagate()[1].numpy()
    np.testing.assert_allclose(ai, ai0 + 0.5 * (A.toarray() @ ai0), atol=1e-5)
    jm = jx.XSimGCL(JModelConfig(use_item_item=True, i2i_alpha=0.5, **kw), jg,
                    i2i=JItemItemGraph.from_scipy(A, 64), ell=jell_from_interactions(jd))
    params = {k: jnp.asarray(v.detach().numpy()) for k, v in with_i2i.state_dict().items()}
    np.testing.assert_allclose(ai, np.asarray(jm.propagate(params)[1]), rtol=RTOL, atol=ATOL)
