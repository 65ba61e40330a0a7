"""The port's PureMF and NGCF (`gsrs_tpu_torch.models.mf`, ``ngcf``) and
its model registry against the JAX package's on JAX-CPU: PureMF is the
zero-layer LightGCN; NGCF's propagation, loss and gradients equal JAX's
on the ELL and segment layouts from JAX's initial parameters (carried
over by `params_from_jax`), with ``reg_mode`` pinned to "ego" so W1/W2
get a gradient from the loss and the tables from the L2 term; NGCF on
the hybrid and tiled layouts equals NGCF on the ELL layout; and
`build_model` builds every registered name (UltraGCN with its cache
directory). fp32 within rtol 1e-5, atol 1e-6: sums of O(1) in another
order."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="the JAX package is the reference these tests compare with")

import jax
import jax.numpy as jnp

from gsrs_tpu.config import ModelConfig as JModelConfig
from gsrs_tpu.data.adjacency import build_graph as jbuild_graph
from gsrs_tpu.data.synthetic import clustered as jclustered
from gsrs_tpu.models import registry as jregistry
from gsrs_tpu.ops.ell import ell_from_interactions as jell_from_interactions
from gsrs_tpu_torch.config import ModelConfig
from gsrs_tpu_torch.convert import params_from_jax
from gsrs_tpu_torch.data import adjacency as tadj
from gsrs_tpu_torch.data import synthetic as tsyn
from gsrs_tpu_torch.models.lightgcn import LightGCN
from gsrs_tpu_torch.models.registry import MODELS, build_model

RTOL, ATOL = 1e-5, 1e-6
CPU = "cpu"
N, M = 64, 96


def _setup(seed=3):
    jd = jclustered(N, M, n_clusters=4, seed=seed)
    td = tsyn.clustered(N, M, n_clusters=4, seed=seed)
    return jd, td, jbuild_graph(jd, 256), tadj.build_graph(td, 256)


def _batch(seed=8, B=32):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, k, B) for k in (N, M, M))


def _jax_model(kw, jd, jg):
    cfg = JModelConfig(**kw)
    ell = jell_from_interactions(jd) if cfg.spmm_mode == "ell" else None
    return jregistry.build_model(cfg, jg, ell=ell)


def _pair(kw, key=0):
    """(JAX model, its params, the port's model holding the same params)."""
    jd, td, jg, tg = _setup()
    jm = _jax_model(kw, jd, jg)
    params = jm.init_params(jax.random.key(key))
    tm = build_model(ModelConfig(**kw), tg, device=CPU)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tm.cfg, CPU))
    return jm, params, tm


def test_puremf_is_the_zero_layer_lightgcn():
    """Whatever the config asks for, PureMF has no layers, no i2i and no
    dropout: its tables are its embeddings, as JAX's PureMF."""
    kw = dict(model="mf", num_layers=3, embedding_dim=8, use_item_item=True, dropout=True)
    jm, params, mf = _pair(kw)
    _, _, _, tg = _setup()
    lgn = LightGCN(ModelConfig(num_layers=0, embedding_dim=8), tg, device=CPU)
    lgn.load_state_dict(mf.state_dict())
    assert (mf.cfg.num_layers, mf.cfg.use_item_item, mf.cfg.dropout) == (0, False, False)
    assert mf.ell is None and mf.i2i is None
    with torch.no_grad():
        for a, b, j in zip(mf.propagate(), lgn.propagate(), jm.propagate(params)):
            assert torch.equal(a, b)
            np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    users, pos, neg = (torch.from_numpy(a) for a in _batch())
    a = mf.bpr_loss(users, pos, neg, torch.Generator().manual_seed(1))[0]
    b = lgn.bpr_loss(users, pos, neg)[0]
    assert torch.equal(a, b)


@pytest.mark.parametrize("layout", ["ell", "segment"])
def test_ngcf_propagation_matches_jax(layout):
    kw = dict(model="ngcf", num_layers=2, embedding_dim=8, spmm_mode=layout)
    jm, params, tm = _pair(kw)
    assert set(tm.state_dict()) == set(params)
    assert len(list(tm.parameters())) == 2 + 4 * 2  # K3's leaves a step
    with torch.no_grad():
        got = tm.propagate()
    for g, w in zip(got, jm.propagate(params)):
        assert g.shape == (w.shape[0], 8 * 3)  # d·(K+1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", ["ell", "segment"])
def test_ngcf_loss_and_gradients_match_jax(layout):
    """BPR + decay·reg with reg on the raw table rows ("ego", pinned even
    where the config says "propagated"): the loss and every parameter's
    gradient, W1/W2 and the biases included, equal JAX's."""
    kw = dict(model="ngcf", num_layers=2, embedding_dim=8, spmm_mode=layout,
              reg_mode="propagated")
    jm, params, tm = _pair(kw)
    assert tm.cfg.reg_mode == jm.cfg.reg_mode == "ego"
    decay = 1e-2
    users, pos, neg = _batch()

    def jloss(p):
        loss, aux = jm.bpr_loss(p, jnp.asarray(users), jnp.asarray(pos), jnp.asarray(neg))
        return loss + decay * aux["reg"]

    jval, jgrads = jax.value_and_grad(jloss)(params)
    loss, aux = tm.bpr_loss(*(torch.from_numpy(a) for a in (users, pos, neg)))
    total = loss + decay * aux["reg"]
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jval), rtol=RTOL)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tm.cfg, CPU)
    for name, p in tm.named_parameters():
        assert float(p.grad.abs().sum()) > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("layout", ["hybrid", "tiled", "segment"])
def test_ngcf_runs_each_layout_as_the_ell_layout(layout):
    """NGCF's layers run through the model's layout (JAX runs the segment
    layer for every layout but ELL; each computes the same product, and
    the port's segment layout is the ELL one)."""
    from gsrs_tpu_torch.ops.ell import EllGraph
    from gsrs_tpu_torch.ops.hybrid import HybridGraph
    from gsrs_tpu_torch.ops.tiled import TiledGraph

    _, _, _, tg = _setup()
    base = dict(model="ngcf", num_layers=2, embedding_dim=8, hybrid_cols=24, tiled_groups=4,
                tiled_cols=16)
    ell = build_model(ModelConfig(**base), tg, device=CPU)
    other = build_model(ModelConfig(spmm_mode=layout, **base), tg, device=CPU)
    kind = {"hybrid": HybridGraph, "tiled": TiledGraph, "segment": EllGraph}[layout]
    assert isinstance(other.ell, kind)
    other.load_state_dict(ell.state_dict())
    users, pos, neg = (torch.from_numpy(a) for a in _batch())
    grads = []
    for model in (ell, other):
        loss, aux = model.bpr_loss(users, pos, neg)
        (loss + 1e-3 * aux["reg"]).backward()
        grads.append([loss.detach()] + [p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


def test_ngcf_init_is_glorot_from_the_host_generator():
    _, _, _, tg = _setup()
    cfg = ModelConfig(model="ngcf", num_layers=3, embedding_dim=32)
    a = build_model(cfg, tg, device=CPU, generator=torch.Generator().manual_seed(5))
    b = build_model(cfg, tg, device=CPU, generator=torch.Generator().manual_seed(5))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    w = torch.cat([a.state_dict()[f"ngcf_w{j}_{k}"].reshape(-1) for j in (1, 2) for k in range(3)])
    assert abs(float(w.std()) - np.sqrt(2.0 / 64)) < 0.01
    assert all(float(a.state_dict()[f"ngcf_b{j}_{k}"].abs().sum()) == 0
               for j in (1, 2) for k in range(3))


def test_build_model_builds_every_registered_name(tmp_path):
    from gsrs_tpu_torch.models.mf import PureMF
    from gsrs_tpu_torch.models.ngcf import NGCF
    from gsrs_tpu_torch.models.ultragcn import UltraGCN
    from gsrs_tpu_torch.models.xsimgcl import XSimGCL

    assert set(MODELS) == set(jregistry.MODELS)
    assert MODELS == {"lgn": LightGCN, "mf": PureMF, "ngcf": NGCF, "xsimgcl": XSimGCL,
                      "ultragcn": UltraGCN}
    _, _, _, tg = _setup()
    for name, cls in MODELS.items():
        m = build_model(ModelConfig(model=name, num_layers=2, embedding_dim=8), tg, device=CPU,
                        cache_dir=str(tmp_path))
        assert type(m) is cls
        width = 8 * 3 if name == "ngcf" else 8
        assert m.final_embeddings()[1].shape == (M, width)
    assert m._ii_cache_dir == str(tmp_path)
    with pytest.raises(ValueError, match="not registered"):
        build_model(ModelConfig(model="nope"), tg, device=CPU)
