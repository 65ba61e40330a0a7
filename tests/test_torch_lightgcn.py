"""The port's LightGCN against the JAX package: JAX ``init_params`` →
``params_from_jax`` → ``final_embeddings`` must agree at fp32 for 0, 1
and 3 layers, with and without the pop gate."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="the JAX package is the reference these tests compare with")

import jax

from gsrs_tpu.config import ModelConfig as JaxModelConfig
from gsrs_tpu.data import adjacency as jadj
from gsrs_tpu.data import synthetic as jsyn
from gsrs_tpu.models import lightgcn as jlgn
from gsrs_tpu.models.registry import build_model as jax_build_model
from gsrs_tpu.ops.ell import ell_from_interactions as jax_ell
from gsrs_tpu_torch.config import ModelConfig
from gsrs_tpu_torch.convert import params_from_jax
from gsrs_tpu_torch.data import adjacency as tadj
from gsrs_tpu_torch.data import synthetic as tsyn
from gsrs_tpu_torch.models import lightgcn as tlgn
from gsrs_tpu_torch.models.registry import build_model
from gsrs_tpu_torch.ops.ell import ell_from_interactions

RTOL, ATOL = 1e-5, 1e-6  # fp32, summation order only
CPU = "cpu"


def _pair(num_layers=2, use_pop_gate=False, bf16=False, dim=8, seed=0):
    """(jax model, jax params, port model with the same params)."""
    kw = dict(num_layers=num_layers, embedding_dim=dim, use_pop_gate=use_pop_gate,
              bf16_compute=bf16, pop_hidden=8, gate_hidden=16)
    jd, td = jsyn.powerlaw(60, 90, avg_degree=6, seed=3), tsyn.powerlaw(60, 90, avg_degree=6, seed=3)
    jm = jax_build_model(JaxModelConfig(**kw), jadj.build_graph(jd, 256), ell=jax_ell(jd))
    params = jm.init_params(jax.random.key(seed))
    tm = build_model(ModelConfig(**kw), tadj.build_graph(td, 256), ell=ell_from_interactions(td),
                     device=CPU)
    tm.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in params.items()},
                                       tm.cfg, CPU))
    return jm, params, tm


@pytest.mark.parametrize("num_layers", [0, 1, 3])
@pytest.mark.parametrize("use_pop_gate", [False, True])
def test_final_embeddings_match_jax(num_layers, use_pop_gate):
    jm, params, tm = _pair(num_layers, use_pop_gate)
    ju, ji, jg = jm.final_embeddings(params)
    with torch.no_grad():
        tu, ti, tg = tm.final_embeddings()
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL, atol=ATOL)
    assert (tg is None) == (jg is None)
    if tg is not None:
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL, atol=ATOL)


def test_bf16_propagation_matches_jax_within_bf16_rounding():
    """bf16 rounds at other points in the two frameworks (inside the
    einsum and the layer sums), so the bound is 2e-2 of the largest
    magnitude, a few bf16 ulps, instead of the fp32 tolerance."""
    jm, params, tm = _pair(num_layers=3, bf16=True)
    ju, ji = jm.propagate(params)
    with torch.no_grad():
        tu, ti = tm.propagate()
    assert tu.dtype == torch.float32 and ti.dtype == torch.float32
    for t, j in ((tu, ju), (ti, ji)):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= 2e-2 * np.abs(j).max()


def test_users_rating_and_forward_match_jax():
    jm, params, tm = _pair(num_layers=2, use_pop_gate=True)
    users = np.array([0, 5, 17, 59])
    items = np.array([3, 3, 80, 1])
    with torch.no_grad():
        rating = tm.users_rating(torch.from_numpy(users))
        pair = tm(torch.from_numpy(users), torch.from_numpy(items))
    np.testing.assert_allclose(rating.numpy(), np.asarray(jm.users_rating(params, users)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pair.numpy(), np.asarray(jm.forward(params, users, items)),
                               rtol=RTOL, atol=ATOL)


def test_popularity_scalar_matches_jax():
    deg = np.random.default_rng(0).integers(0, 50, 300).astype(np.float32)
    np.testing.assert_allclose(tlgn.popularity_scalar(torch.from_numpy(deg)).numpy(),
                               np.asarray(jlgn.popularity_scalar(deg)), rtol=RTOL, atol=ATOL)


def test_params_from_jax_transposes_the_pop_gate():
    _, params, tm = _pair(num_layers=1, use_pop_gate=True)
    np.testing.assert_array_equal(tm.gate_fc1.weight.detach().numpy(),
                                  np.asarray(params["gate_w1"]).T)
    assert tm.pop_fc1.weight.shape == (8, 1)
    with pytest.raises(ValueError, match="do not match"):
        params_from_jax({"user_emb": np.zeros((2, 8))}, tm.cfg, CPU)


def test_init_params_is_seeded_and_scaled():
    graph = tadj.build_graph(tsyn.powerlaw(400, 500, seed=0), 256)
    cfg = ModelConfig(num_layers=1, embedding_dim=32, use_pop_gate=True)
    a = tlgn.LightGCN(cfg, graph, device=CPU, generator=torch.Generator().manual_seed(4))
    b = tlgn.LightGCN(cfg, graph, device=CPU, generator=torch.Generator().manual_seed(4))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert abs(float(a.item_emb.detach().std()) - 0.1) < 0.005
    assert float(a.gate_fc1.weight.detach().abs().max()) <= 1 / np.sqrt(2 * 32)


@pytest.mark.parametrize("change,err", [
    (dict(spmm_mode="segment"), None),  # every layout computes the same product
    (dict(spmm_mode="hybrid"), None),
    (dict(spmm_mode="csr"), ValueError),
    (dict(use_item_item=True), None),  # no i2i graph given: no smoothing, as in JAX
    (dict(model="ngcf"), None),  # the zoo is ported: a d·(K+1)-wide readout
    (dict(model="nope"), ValueError),
])
def test_unported_options_raise(change, err):
    graph = tadj.build_graph(tsyn.powerlaw(20, 30, seed=0), 256)
    if err is None:
        model = build_model(ModelConfig(embedding_dim=4, **change), graph, device=CPU)
        plain = build_model(ModelConfig(embedding_dim=4), graph, device=CPU)
        assert model.i2i is None
        with torch.no_grad():
            got, want = model.propagate(), plain.propagate()
        if change.get("model") == "ngcf":
            assert got[1].shape == (30, 4 * (model.cfg.num_layers + 1))
            return
        # bitwise where only the i2i flag changed; the layouts sum in another order
        tol = 0 if "spmm_mode" not in change else 1e-6
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=tol, atol=tol)
        return
    with pytest.raises(err):
        build_model(ModelConfig(embedding_dim=4, **change), graph, device=CPU)
