"""The port's segment layout (`gsrs_tpu_torch.ops.spmm`: the ELL layout
under JAX's interface) against the JAX package's on JAX-CPU: the layer
forward and VJP in fp32 against JAX's `propagate_layer` and against the
dense oracle (`dense_normalized_adjacency`), with and without an edge
mask; in bf16 against JAX's within their rounding limits; the masks
permuted into both sort orders as JAX permutes them; and LightGCN on the
segment layout equal to LightGCN on the ELL layout, with and without
dropout. Cases marked ``gpu`` run the layer on a CUDA card."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="the JAX package is the reference these tests compare with")

import jax
import jax.numpy as jnp

from gsrs_tpu.data import adjacency as jadj
from gsrs_tpu.data import synthetic as jsyn
from gsrs_tpu.ops import spmm as jspmm
from gsrs_tpu_torch.config import ModelConfig
from gsrs_tpu_torch.data import adjacency as tadj
from gsrs_tpu_torch.data import synthetic as tsyn
from gsrs_tpu_torch.models.registry import build_model
from gsrs_tpu_torch.ops import ell as tell
from gsrs_tpu_torch.ops import spmm as tspmm

RTOL, ATOL = 1e-5, 1e-6  # fp32: sums of O(1) in another order
BF16_ULP = 2.0**-8  # one rounding to bf16, relative
CPU = "cpu"


def _graphs(seed=3):
    jd, td = jsyn.clustered(64, 96, n_clusters=4, seed=seed), tsyn.clustered(64, 96, n_clusters=4,
                                                                            seed=seed)
    return jd, td, jadj.build_graph(jd, 256), tadj.build_graph(td, 256)


def _arrays(n, m, seed=2, d=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((k, d)).astype(np.float32) for k in (n, m, n, m)]


def _mask(E, seed=4):
    rng = np.random.default_rng(seed)
    return ((rng.random(E) < 0.6) / 0.6).astype(np.float32)


def _port_vjp(graph, arrays, masks, to):
    u, x, gu, gx = (to(a) for a in arrays)
    u, x = u.requires_grad_(), x.requires_grad_()
    nu, ni = tspmm.propagate_layer(graph, u, x, masks)
    torch.autograd.backward((nu, ni), (gu, gx))
    return [t.detach().float().numpy() for t in (nu, ni, u.grad, x.grad)]


def _jax_vjp(jgraph, arrays, masks, dtype):
    u, x, gu, gx = (jnp.asarray(a, dtype) for a in arrays)
    (nu, ni), vjp = jax.vjp(lambda a, b: jspmm.propagate_layer(jgraph, a, b, masks), u, x)
    du, dx = vjp((gu, gx))
    return [np.asarray(t.astype(jnp.float32)) for t in (nu, ni, du, dx)]


def _permuted(keep, graph):
    return keep[graph.perm_by_u], keep[graph.perm_by_i]


def test_segment_layout_is_the_ell_layout_of_the_canonical_edges():
    """`canonical_edges` inverts the by-user sort to the dataset's edge
    list (JAX's arrays, padding dropped), the segment model's layout is
    the ELL layout built from it, equal to JAX's `ell_from_graph`, and
    each ELL side holds JAX's by-destination sort order: row by row, the
    sources of the sorted arrays in their order."""
    from gsrs_tpu.ops import ell as jell
    from gsrs_tpu_torch.models.lightgcn import default_layout

    jd, td, jg, tg = _graphs()
    users, items, w = tadj.canonical_edges(tg)
    np.testing.assert_array_equal(users, td.train_users)
    np.testing.assert_array_equal(items, td.train_items)
    np.testing.assert_array_equal(w, np.asarray(jg.edge_w_by_u)[np.argsort(jg.perm_by_u)][:tg.n_edges])
    ell = default_layout(ModelConfig(spmm_mode="segment"), tg)
    want = jell.ell_from_graph(jg)
    for side, jside, dst, src in ((ell.by_user, want.by_user, jg.edge_u_by_u, jg.edge_i_by_u),
                                  (ell.by_item, want.by_item, jg.edge_i_by_i, jg.edge_u_by_i)):
        np.testing.assert_array_equal(side.assemble.numpy(), np.asarray(jside.assemble))
        rows, cols, ws = [], [], []
        for b, jb in zip(side.buckets, jside.buckets):
            for f in ("rows", "cols", "w", "eidx"):
                np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(jb, f)))
            real = b.w.numpy() != 0
            rows.append(np.repeat(b.rows.numpy(), b.cols.shape[1])[real.ravel()])
            cols.append(b.cols.numpy()[real])
        rows, cols = np.concatenate(rows), np.concatenate(cols)
        order = np.argsort(rows, kind="stable")
        real = np.asarray(jg.edge_w_by_u if side is ell.by_user else jg.edge_w_by_i) != 0
        np.testing.assert_array_equal(rows[order], np.asarray(dst)[real])
        np.testing.assert_array_equal(cols[order], np.asarray(src)[real])


@pytest.mark.parametrize("masked", [False, True])
def test_layer_and_vjp_match_jax_and_the_dense_oracle(masked):
    jd, td, jg, tg = _graphs()
    arrays = _arrays(td.n_users, td.m_items)
    keep = _mask(jg.padded_edges) if masked else None
    tmasks = None if keep is None else tuple(torch.from_numpy(m) for m in _permuted(keep, tg))
    jmasks = None if keep is None else tuple(jnp.asarray(m) for m in _permuted(keep, jg))
    got = _port_vjp(tg, arrays, tmasks, torch.from_numpy)
    want = _jax_vjp(jg, arrays, jmasks, jnp.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    # the dense oracle: new_u = W i, new_i = Wᵀ u; d_user = W g_i, d_item = Wᵀ g_u
    A = tadj.dense_normalized_adjacency(td)
    np.testing.assert_array_equal(A, jadj.dense_normalized_adjacency(jd))
    n = td.n_users
    W = A[:n, n:]
    if keep is not None:  # the mask scales each edge of W
        Wm = np.zeros_like(W)
        E = tg.n_edges
        np.add.at(Wm, (td.train_users, td.train_items), keep[:E])
        W = W * Wm
    u, x, gu, gx = (a.astype(np.float64) for a in arrays)
    for g, w in zip(got, (W @ x, W.T @ u, W @ gx, W.T @ gu)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_bf16_layer_and_vjp_against_jax(masked):
    """bf16: both against the float64 result of the bf16 inputs and the
    bf16-rounded weights (w · mask rounded, as both packages round it).
    The port sums the exact fp32 products in fp32 and rounds once (the
    ELL gather-reduce; two roundings allowed); JAX rounds each product and
    then each addition of its bf16 segment sum, up to the longest run's
    length in all. Each within its own count of roundings (2^-8 relative
    each) of Σ|w||x|, and so within their sum of each other."""
    jd, td, jg, tg = _graphs()
    arrays = [a.astype(jnp.bfloat16).astype(np.float32) for a in _arrays(td.n_users, td.m_items,
                                                                         seed=6)]
    keep = _mask(jg.padded_edges, seed=7) if masked else np.ones(jg.padded_edges, np.float32)
    keep_bf = keep.astype(jnp.bfloat16)
    tmasks = tuple(torch.from_numpy(m.astype(np.float32)).bfloat16()
                   for m in _permuted(keep_bf, tg))
    jmasks = tuple(jnp.asarray(m) for m in _permuted(keep_bf, jg))
    got = _port_vjp(tg, arrays, tmasks, lambda a: torch.from_numpy(a).bfloat16())
    want = _jax_vjp(jg, arrays, jmasks, jnp.bfloat16)

    E = tg.n_edges
    n, m = td.n_users, td.m_items
    w_r = (np.asarray(jg.edge_w_by_u)[np.argsort(np.asarray(jg.perm_by_u))][:E]
           * keep_bf[:E].astype(np.float32)).astype(jnp.bfloat16).astype(np.float64)
    W = np.zeros((n, m))
    np.add.at(W, (td.train_users, td.train_items), w_r)
    u, x, gu, gx = (a.astype(np.float64) for a in arrays)
    exact = (W @ x, W.T @ u, W @ gx, W.T @ gu)
    mag = (abs(W) @ abs(x), abs(W).T @ abs(u), abs(W) @ abs(gx), abs(W).T @ abs(gu))
    longest = int(max(np.bincount(td.train_users).max(), np.bincount(td.train_items).max()))
    for g, w, e, a in zip(got, want, exact, mag):
        port_limit = ((1 + BF16_ULP) ** 2 - 1) * a + ATOL
        jax_limit = ((1 + BF16_ULP) ** (longest + 1) - 1) * a + ATOL
        assert (np.abs(g - e) <= port_limit).all()
        assert (np.abs(w - e) <= jax_limit).all()
        assert (np.abs(g - w) <= port_limit + jax_limit).all()


def test_dropout_masks_permute_as_jax():
    """`make_edge_dropout_masks` is `edge_keep_mask` in canonical order
    permuted by perm_by_u / perm_by_i, as JAX's is (each package draws
    its own stream)."""
    _, _, jg, tg = _graphs()
    keep = tspmm.edge_keep_mask(torch.Generator().manual_seed(3), tg, 0.6)
    by_u, by_i = tspmm.make_edge_dropout_masks(torch.Generator().manual_seed(3), tg, 0.6)
    perm_u, perm_i = np.asarray(jg.perm_by_u), np.asarray(jg.perm_by_i)
    np.testing.assert_array_equal(by_u.numpy(), keep.numpy()[perm_u])
    np.testing.assert_array_equal(by_i.numpy(), keep.numpy()[perm_i])
    key = jax.random.key(5)
    jkeep = np.asarray(jspmm.edge_keep_mask(key, jg, 0.6))
    ju, ji = jspmm.make_edge_dropout_masks(key, jg, 0.6)
    np.testing.assert_array_equal(np.asarray(ju), jkeep[perm_u])
    np.testing.assert_array_equal(np.asarray(ji), jkeep[perm_i])
    # both directions drop the same edges: the edge at by_u position j is
    # canonical edge perm_u[j], which sits at by_i position inv_i[perm_u[j]]
    inv_i = np.argsort(perm_i)
    np.testing.assert_array_equal(by_u.numpy(), by_i.numpy()[inv_i[perm_u]])
    bf = tspmm.make_edge_dropout_masks(torch.Generator().manual_seed(3), tg, 0.6, torch.bfloat16)
    assert bf[0].dtype == torch.bfloat16


@pytest.mark.parametrize("dropout", [False, True])
def test_lightgcn_segment_equals_ell(dropout):
    """The same parameters and the same dropout generator seed: the
    segment and the ELL models draw the same canonical keep mask, so
    their propagations, losses and gradients agree."""
    _, td, _, tg = _graphs()
    kw = dict(num_layers=3, embedding_dim=8, dropout=dropout, keep_prob=0.6)
    seg = build_model(ModelConfig(spmm_mode="segment", **kw), tg, device=CPU)
    ell = build_model(ModelConfig(spmm_mode="ell", **kw), tg, device=CPU)
    assert isinstance(seg.ell, tell.EllGraph)
    ell.load_state_dict(seg.state_dict())
    rng = np.random.default_rng(8)
    users, pos, neg = (torch.from_numpy(rng.integers(0, k, 32)) for k in (64, 96, 96))
    out = []
    for model in (seg, ell):
        gen = torch.Generator().manual_seed(11) if dropout else None
        loss, aux = model.bpr_loss(users, pos, neg, gen)
        (loss + 1e-3 * aux["reg"]).backward()
        out.append([loss.detach(), *(p.grad.clone() for p in model.parameters())])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        for a, b in zip(seg.propagate(), ell.propagate()):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


def test_segment_layout_ignores_a_given_layout_and_zero_layers_build_none():
    """A given ELL layout is the segment layout and is kept; any other is
    ignored for the graph's own, as JAX ignores ``ell`` there."""
    from gsrs_tpu_torch.ops.tiled import tiled_from_interactions

    _, td, _, tg = _graphs()
    given = tell.ell_from_interactions(td)
    cfg = ModelConfig(spmm_mode="segment", num_layers=2, embedding_dim=8)
    kept = build_model(cfg, tg, ell=given, device=CPU)
    assert kept.ell.by_user.assemble is given.by_user.assemble
    m = build_model(cfg, tg, ell=tiled_from_interactions(td, groups=2, cols=16), device=CPU)
    assert isinstance(m.ell, tell.EllGraph)
    m0 = build_model(ModelConfig(spmm_mode="segment", num_layers=0, embedding_dim=8), tg,
                     device=CPU)
    assert m0.ell is None


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the segment sum's card path")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_on_the_card_matches_the_cpu_and_repeats(cuda, dtype):
    """Forward and VJP on the card against the CPU (fp32 within 1e-5;
    bf16 within two roundings each, of the fp32 result), and two calls on
    the card bitwise equal."""
    _, td, _, tg = _graphs()
    arrays = [torch.from_numpy(a).to(dtype).float().numpy()
              for a in _arrays(td.n_users, td.m_items, seed=9)]
    keep = torch.from_numpy(_mask(tg.perm_by_u.size, seed=10)).to(dtype)
    masks = (keep[torch.from_numpy(tg.perm_by_u).long()], keep[torch.from_numpy(tg.perm_by_i).long()])
    want = _port_vjp(tg, arrays, masks, lambda a: torch.from_numpy(a).to(dtype))
    on_card = tell.ell_from_graph(tg).to(cuda)
    cmasks = tuple(t.to(cuda) for t in masks)
    runs = [_port_vjp_card(tg, on_card, arrays, cmasks, dtype, cuda) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    fmasks = tuple(t.float() for t in masks)
    mag = _port_vjp(tg, [np.abs(a) for a in arrays], fmasks, torch.from_numpy)
    for g, w, a in zip(runs[0], want, mag):
        g = g.float().cpu().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        else:  # each within two roundings of the fp32 sum, so within twice that of the other
            assert (np.abs(g - w) <= 2 * (((1 + BF16_ULP) ** 2 - 1) * a + ATOL)).all()


def _port_vjp_card(graph, ell, arrays, masks, dtype, dev):
    u, x, gu, gx = (torch.from_numpy(a).to(dtype).to(dev) for a in arrays)
    u, x = u.requires_grad_(), x.requires_grad_()
    nu, ni = tspmm.propagate_layer(graph, u, x, masks, ell=ell)
    torch.autograd.backward((nu, ni), (gu, gx))
    torch.cuda.synchronize()
    return [t.detach() for t in (nu, ni, u.grad, x.grad)]
