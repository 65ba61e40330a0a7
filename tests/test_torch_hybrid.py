"""The port's hybrid layout (`gsrs_tpu_torch.ops.hybrid`) against the JAX
package's on JAX-CPU, as tests/test_hybrid.py holds JAX's: the layout constructors
array for array (dense blocks in fp32 and in bf16 bits, hub columns, the
residual sides) at several C, C above the source count and C = 0; one
layer forward and VJP with and without the hash mask, against JAX's
hybrid layer and the port's ELL layer, in fp32 and bf16; the memory
guard's clamp and warning; every edge in exactly one of dense and
residual; dropout end to end; and 3 training steps on the hybrid layout
against the ELL layout and against the JAX trainer. Cases marked ``gpu``
run the layer on a CUDA card."""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="the JAX package is the reference these tests compare with")

import jax
import jax.numpy as jnp

from gsrs_tpu.ops import hybrid as jhybrid
from gsrs_tpu.data.synthetic import clustered as jclustered
from gsrs_tpu_torch import config as tcfg
from gsrs_tpu_torch.data import adjacency as tadj
from gsrs_tpu_torch.data import synthetic as tsyn
from gsrs_tpu_torch.models.registry import build_model
from gsrs_tpu_torch.ops import ell as tell
from gsrs_tpu_torch.ops import hybrid as thybrid
from gsrs_tpu_torch.ops.hashdrop import canonical_hash_mask, hash_keep

CPU = "cpu"
ATOL = 1e-5  # fp32: sums of O(1) in another order
# bf16: within k roundings to bf16 (2^-8 relative each) of the fp32 result of the rounded
# inputs, scaled by sum |w| |x|: forward the product or the residual, then their sum; backward
# the hub cotangent or the residual, then their sum in the hub rows; a mask rounds w · mask
# and the masked dense cell once more each
BF16_ROUNDINGS = {"forward": 2, "backward": 2}
BF16_ATOL = 1e-6
DROP = (0x2545F491, 0x9E3779B9, 0.7)  # one key word above 2**31


def _data(seed=3):
    return jclustered(64, 96, n_clusters=4, seed=seed), tsyn.clustered(64, 96, n_clusters=4,
                                                                      seed=seed)


def _chunk_pairs(side):
    """The side's overflow-chunk (dst, pos) pairs, sorted: the port keeps
    them by chunk level (``extra_levels``), JAX by row
    (``extra_dst``/``extra_pos``, None when no row was split)."""
    if hasattr(side, "extra_levels"):
        pairs = [(int(a), int(b)) for d, p in side.extra_levels for a, b in zip(d, p)]
    elif side.extra_dst is None:
        pairs = []
    else:
        pairs = list(zip(np.asarray(side.extra_dst).tolist(), np.asarray(side.extra_pos).tolist()))
    return np.asarray(sorted(pairs), dtype=np.int64).reshape(-1, 2)


def _side_arrays(side):
    out = [np.asarray(side.assemble)]
    for b in side.buckets:
        out += [np.asarray(b.rows), np.asarray(b.cols), np.asarray(b.w), np.asarray(b.eidx)]
    out.append(_chunk_pairs(side))
    return out


def _assert_sides_equal(ours, theirs):
    a, b = _side_arrays(ours), _side_arrays(theirs)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
        else:
            np.testing.assert_array_equal(x, y)


def _assert_layouts_equal(tg, jg, bf16):
    assert (tg.n_users, tg.m_items) == (jg.n_users, jg.m_items)
    for name in ("user_from_item", "item_from_user"):
        j, t = getattr(jg, name), getattr(tg, name)
        if bf16:
            assert t.dense.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.dense.view(torch.int16).numpy(),
                                          np.asarray(j.dense).view(np.int16))
        else:
            assert t.dense.dtype == torch.float32
            np.testing.assert_array_equal(t.dense.numpy(), np.asarray(j.dense))
        np.testing.assert_array_equal(t.top_src.numpy(), np.asarray(j.top_src))
        _assert_sides_equal(t.residual.by_user, j.residual.by_user)
        _assert_sides_equal(t.residual.by_item, j.residual.by_item)
        # the residual's canonical edge list, in eidx order, is what its slots hold
        for b in t.residual.by_user.buckets:
            real = b.w != 0
            rows = b.rows[:, None].expand_as(b.cols)[real]
            np.testing.assert_array_equal(t.res_dst[b.eidx[real].long()].numpy(), rows.numpy())
            np.testing.assert_array_equal(t.res_src[b.eidx[real].long()].numpy(),
                                          b.cols[real].numpy())


@pytest.mark.parametrize("cols", [8, 32, 96, 8192])
@pytest.mark.parametrize("bf16", [False, True])
def test_constructors_give_the_jax_layout(cols, bf16):
    """Both constructors, from the data and from the graph, at C under, at and
    over the source count (C is clamped to it)."""
    jd, td = _data()
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jg = jhybrid.hybrid_from_interactions(jd, cols=cols, dtype=jdt)
    tg = thybrid.hybrid_from_interactions(td, cols=cols, dtype=tdt)
    _assert_layouts_equal(tg, jg, bf16)
    assert tg.user_from_item.dense.shape[1] == min(cols, td.m_items)
    from gsrs_tpu.data.adjacency import build_graph as jbuild_graph

    _assert_layouts_equal(thybrid.hybrid_from_graph(tadj.build_graph(td, 256), cols=cols,
                                                    dtype=tdt),
                          jhybrid.hybrid_from_graph(jbuild_graph(jd, 256), cols=cols, dtype=jdt),
                          bf16)


def test_constructor_at_128_multiples_and_ties():
    """C ≥ 128 under the source count rounds down to a multiple of 128;
    equal degrees order by the reversed stable sort (higher id first)."""
    jd, td = jsyn_powerlaw(400, 500), tsyn.powerlaw(400, 500, avg_degree=6, seed=4)
    jg = jhybrid.hybrid_from_interactions(jd, cols=300)
    tg = thybrid.hybrid_from_interactions(td, cols=300)
    assert tg.user_from_item.top_src.numel() == 256
    _assert_layouts_equal(tg, jg, False)


def jsyn_powerlaw(n, m):
    from gsrs_tpu.data.synthetic import powerlaw

    return powerlaw(n, m, avg_degree=6, seed=4)


def test_memory_guard_clamps_and_degenerates_to_ell():
    """The guard's warning is JAX's, word for word; at C = 0 the layout is
    the plain ELL, forward and backward."""
    jd, td = _data()
    with pytest.warns(UserWarning, match="dense blocks disabled"):
        tg = thybrid.hybrid_from_interactions(td, cols=8192, hbm_budget_gb=1e-7)
    with pytest.warns(UserWarning, match="dense blocks disabled"):
        jg = jhybrid.hybrid_from_interactions(jd, cols=8192, hbm_budget_gb=1e-7)
    assert tg.user_from_item.dense.shape == (64, 0) and tg.item_from_user.top_src.numel() == 0
    _assert_layouts_equal(tg, jg, False)
    ell = tell.ell_from_interactions(td)
    got = _layer_vjp(thybrid.hybrid_propagate_layer, tg, _arrays(), None)
    want = _layer_vjp(tell.ell_propagate_layer, ell, _arrays(), None)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
    with pytest.warns(UserWarning, match="clamping to C=256") as ours:
        assert thybrid.resolve_hybrid_cols(30000, 40000, 8192, torch.bfloat16, 0.04) == 256
    with pytest.warns(UserWarning) as theirs:
        jhybrid.resolve_hybrid_cols(30000, 40000, 8192, np.float16, 0.04)
    assert str(ours[0].message) == str(theirs[0].message)
    assert thybrid.resolve_hybrid_cols(1000, 1000, 512, torch.float32, 1.0) == 512


def test_dense_and_residual_cover_every_edge_once():
    _, td = _data()
    tg = thybrid.hybrid_from_interactions(td, cols=32)
    E = td.train_size
    for d in (tg.user_from_item, tg.item_from_user):
        n_dense = int((d.dense != 0).sum())
        n_res = sum(int((b.w != 0).sum()) for b in d.residual.by_user.buckets)
        assert n_dense + n_res == E and d.res_dst.numel() == n_res
        assert torch.unique(d.top_src).numel() == d.top_src.numel()  # the hub rows' add is safe


def _arrays(seed=2, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, 8)).astype(np.float32) for n in (64, 96, 64, 96)]


def _layer_vjp(layer, graph, arrays, masks, to=torch.from_numpy):
    u, x, gu, gx = (to(a) for a in arrays)
    u, x = u.requires_grad_(), x.requires_grad_()
    nu, ni = layer(graph, u, x, masks)
    torch.autograd.backward((nu, ni), (gu, gx))
    return nu.detach(), ni.detach(), u.grad, x.grad


def _jax_layer_vjp(hg, arrays, drop, dtype):
    u, x, gu, gx = (jnp.asarray(a, dtype) for a in arrays)
    (nu, ni), vjp = jax.vjp(lambda a, b: jhybrid.hybrid_propagate_layer(hg, a, b, drop), u, x)
    du, dx = vjp((gu, gx))
    return tuple(np.asarray(a.astype(jnp.float32)) for a in (nu, ni, du, dx))


def _jdrop(masked):
    if not masked:
        return None
    return (jnp.uint32(DROP[0]), jnp.uint32(DROP[1]), jnp.float32(DROP[2]))


@pytest.mark.parametrize("cols", [8, 32, 96])
@pytest.mark.parametrize("masked", [False, True])
def test_layer_matches_jax_and_ell_fp32(cols, masked):
    """Forward and VJP, 1e-5: against JAX's hybrid layer on the same
    layout, and against the port's ELL layer with the same edges kept (the
    hash mask in canonical edge order)."""
    jd, td = _data()
    tg = thybrid.hybrid_from_interactions(td, cols=cols)
    drop = DROP if masked else None
    arrays = _arrays()
    got = _layer_vjp(thybrid.hybrid_propagate_layer, tg, arrays, thybrid.hybrid_masks(tg, drop))
    want = _jax_layer_vjp(jhybrid.hybrid_from_interactions(jd, cols=cols), arrays, _jdrop(masked),
                          np.float32)
    mask = canonical_hash_mask(torch.from_numpy(td.train_users), torch.from_numpy(td.train_items),
                               drop)
    if masked:
        assert 0 < float((mask == 0).float().mean()) < 1
    via_ell = _layer_vjp(tell.ell_propagate_layer, tell.ell_from_interactions(td), arrays, mask)
    for g, w, e in zip(got, want, via_ell):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0)
        np.testing.assert_allclose(g.numpy(), e.numpy(), atol=ATOL, rtol=0)


def _bf16_reference(td, arrays, drop):
    """(exact, limits) of a bf16 hybrid layer's (new_u, new_i, d_user,
    d_item) on the bf16 values ``arrays``: the port's ELL layer in fp32
    with the bf16-rounded weights (and the hash mask in canonical order),
    and the BF16_ROUNDINGS limit around it, scaled by the same layer on
    |weights| and |inputs|."""
    ell = tell.ell_from_interactions(td)
    rounded = dataclasses.replace(ell, **{s: dataclasses.replace(getattr(ell, s), buckets=tuple(
        dataclasses.replace(b, w=b.w.bfloat16().float()) for b in getattr(ell, s).buckets))
        for s in ("by_user", "by_item")})
    mask = canonical_hash_mask(torch.from_numpy(td.train_users),
                               torch.from_numpy(td.train_items), drop)
    exact = _layer_vjp(tell.ell_propagate_layer, rounded, arrays, mask)
    mag = _layer_vjp(tell.ell_propagate_layer, rounded, [np.abs(a) for a in arrays], mask)
    limits = []
    for i, m in enumerate(mag):
        k = BF16_ROUNDINGS["forward" if i < 2 else "backward"] + 2 * int(drop is not None)
        limits.append(((1 + 2.0**-8) ** k - 1) * m.numpy() + BF16_ATOL)
    return [e.numpy() for e in exact], limits


@pytest.mark.parametrize("masked", [False, True])
def test_layer_matches_jax_bf16(masked):
    """bf16 forward and VJP against JAX's bf16 hybrid layer, within twice
    the rounding limit of each (BF16_ROUNDINGS), and both within it of the
    fp32 result of the rounded inputs (`_bf16_reference`)."""
    jd, td = _data()
    tg = thybrid.hybrid_from_interactions(td, cols=24, dtype=torch.bfloat16)
    drop = DROP if masked else None
    arrays = [a.astype(jnp.bfloat16).astype(np.float32) for a in _arrays(5)]
    got = _layer_vjp(thybrid.hybrid_propagate_layer, tg, arrays, thybrid.hybrid_masks(tg, drop),
                     lambda a: torch.from_numpy(a).bfloat16())
    assert all(g.dtype == torch.bfloat16 for g in got)
    want = _jax_layer_vjp(jhybrid.hybrid_from_interactions(jd, cols=24, dtype=jnp.bfloat16),
                          arrays, _jdrop(masked), jnp.bfloat16)
    exact, limits = _bf16_reference(td, arrays, drop)
    for g, w, e, limit in zip(got, want, exact, limits):
        g = g.float().numpy()
        assert (np.abs(g - e) <= limit).all()
        assert (np.abs(w - e) <= limit).all()
        assert (np.abs(g - w) <= 2 * limit).all()


def test_masks_are_a_function_of_the_key_and_keep_the_keep_rate():
    _, td = _data()
    tg = thybrid.hybrid_from_interactions(td, cols=16)
    a, b = thybrid.hybrid_masks(tg, DROP), thybrid.hybrid_masks(tg, DROP)
    for x, y in zip(a, b):
        assert torch.equal(x.dense, y.dense) and torch.equal(x.residual, y.residual)
    assert thybrid.hybrid_masks(tg, None) is None
    # a dense cell is the edge (r, top_src[c]) of the canonical hash mask
    d = tg.user_from_item
    cells = torch.nonzero(d.dense)
    want = canonical_hash_mask(cells[:, 0], d.top_src[cells[:, 1]].long(), DROP)
    torch.testing.assert_close(a[0].dense[cells[:, 0], cells[:, 1]],
                               d.dense[cells[:, 0], cells[:, 1]] * want)
    # hashing the nonzero cells only gives the JAX package's every-cell product, bit for bit
    for dense16 in (False, True):
        hg = thybrid.hybrid_from_interactions(td, cols=16, dtype=torch.bfloat16) if dense16 else tg
        for k, (d, dst_is_user) in enumerate(((hg.user_from_item, True),
                                              (hg.item_from_user, False))):
            r = torch.arange(d.dense.shape[0])[:, None]
            c = d.top_src[None, :].long()
            uu, ii = (r, c) if dst_is_user else (c, r)
            every = d.dense * hash_keep(uu, ii, DROP, dtype=d.dense.dtype)
            assert torch.equal(thybrid.hybrid_masks(hg, DROP)[k].dense, every)
    kept = float((canonical_hash_mask(torch.arange(2000)[:, None], torch.arange(500)[None, :],
                                      DROP) > 0).float().mean())
    assert abs(kept - 0.7) < 0.01


def test_model_builds_hybrid_and_drops_end_to_end():
    """LightGCN(spmm_mode="hybrid") builds the layout from the graph (the
    same as from the data, in the compute dtype); with dropout one
    generator seed reproduces the loss, another changes it, and no
    dropout differs from dropout."""
    _, td = _data()
    graph = tadj.build_graph(td, 256)
    cfg = tcfg.ModelConfig(num_layers=2, embedding_dim=8, spmm_mode="hybrid", hybrid_cols=16,
                           dropout=True, keep_prob=0.6, bf16_compute=True)
    model = build_model(cfg, graph, device=CPU)
    assert isinstance(model.ell, thybrid.HybridGraph)
    want = thybrid.hybrid_from_interactions(td, cols=16, dtype=torch.bfloat16)
    for name in ("user_from_item", "item_from_user"):
        a, b = getattr(model.ell, name), getattr(want, name)
        for f in ("dense", "top_src", "res_dst", "res_src"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    rng = np.random.default_rng(6)
    users, pos, neg = (torch.from_numpy(rng.integers(0, k, 32)) for k in (64, 96, 96))
    with torch.no_grad():
        l1 = model.bpr_loss(users, pos, neg, torch.Generator().manual_seed(1))[0]
        l1b = model.bpr_loss(users, pos, neg, torch.Generator().manual_seed(1))[0]
        l2 = model.bpr_loss(users, pos, neg, torch.Generator().manual_seed(2))[0]
        l0 = model.bpr_loss(users, pos, neg)[0]
    assert float(l1) == float(l1b) and float(l1) != float(l2) and float(l1) != float(l0)


def _trainers(tmp_path, layout):
    from gsrs_tpu.config import (
        ExperimentConfig as JExp, ModelConfig as JModel, TrainConfig as JTrain,
    )
    from gsrs_tpu.data.adjacency import build_graph as jbuild_graph
    from gsrs_tpu.models.registry import build_model as jbuild_model
    from gsrs_tpu.train.trainer import Trainer as JTrainer
    from gsrs_tpu_torch.train.trainer import Trainer

    jd, td = _data()
    model_kw = dict(num_layers=3, embedding_dim=8, spmm_mode=layout, hybrid_cols=24)
    train_kw = dict(batch_size=64, lr=1e-2, decay=1e-3, fused_adam="off", neg_candidates=4)
    jcfg = JExp(model=JModel(**model_kw),
                train=JTrain(checkpoint_dir=str(tmp_path), tensorboard=False, **train_kw))
    jgraph = jbuild_graph(jd, edge_pad_multiple=256)
    jtr = JTrainer(jcfg, jd, jgraph, jbuild_model(jcfg.model, jgraph), run_eval=False)
    cfg = tcfg.ExperimentConfig(model=tcfg.ModelConfig(**model_kw),
                                train=tcfg.TrainConfig(**train_kw))
    tgraph = tadj.build_graph(td, edge_pad_multiple=256)
    ttr = Trainer(cfg, td, tgraph, build_model(cfg.model, tgraph, device=CPU), run_eval=False,
                  device=CPU)
    return jtr, ttr


def test_three_steps_match_the_ell_layout_and_the_jax_trainer(tmp_path):
    """fp32, Adam "off": the port's hybrid trainer, the port's ELL trainer
    and the JAX hybrid trainer take the same three steps from JAX's
    initial parameters; losses and parameters within 1e-5."""
    from gsrs_tpu_torch.convert import params_from_jax

    jtr, ttr = _trainers(tmp_path, "hybrid")
    _, etr = _trainers(tmp_path, "ell")
    assert isinstance(jtr.model.ell, jhybrid.HybridGraph)
    assert isinstance(ttr.model.ell, thybrid.HybridGraph)
    epoch_fn = jtr._build_epoch_fn()
    state = jtr.init_state()
    params, opt_state = state.params, state.opt_state
    start = params_from_jax(jax.tree.map(np.asarray, params), ttr.cfg.model, CPU)
    rng = np.random.default_rng(9)
    batch = tuple(rng.integers(0, n, (3, 64)) for n in (64, 96, 96))
    jlosses = []
    for s in range(3):
        u, p, n = (jnp.asarray(a[s:s + 1], jnp.int32) for a in batch)
        params, opt_state, loss = epoch_fn(params, opt_state, jtr.graph, jtr.model.ell, u, p, n,
                                           jax.random.split(jax.random.key(0), 1))
        jlosses.append(float(loss))
    want = params_from_jax(jax.tree.map(np.asarray, params), ttr.cfg.model, CPU)
    for tr in (ttr, etr):
        tstate = tr.init_state()
        tr.model.load_state_dict(start)
        tstate, tlosses = tr.run_steps(tstate, *batch)
        np.testing.assert_allclose(tlosses.numpy(), jlosses, rtol=1e-5)
        for k, p in tr.model.named_parameters():
            torch.testing.assert_close(p.detach(), want[k], atol=1e-5, rtol=0)


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 is CUDA C++ with no CPU mode")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_layer_on_the_card_matches_the_cpu(cuda, dtype, masked):
    """The hybrid layer forward and VJP on the card (K4 on both residual
    sides of both directions, which must launch) against the CPU's plain
    version: fp32 within 1e-5; bf16 both within the rounding limit of the
    fp32 result of the rounded inputs, so within twice it of each other;
    two calls on the card bitwise equal."""
    from gsrs_tpu_torch.ops import ell_kernel

    td = tsyn.powerlaw(300, 400, avg_degree=8, seed=2)
    hg = thybrid.hybrid_from_interactions(td, cols=64, dtype=dtype)
    rng = np.random.default_rng(7)
    arrays = [rng.standard_normal((k, 16)).astype(np.float32)
              for k in (td.n_users, td.m_items, td.n_users, td.m_items)]
    if dtype == torch.bfloat16:
        arrays = [torch.from_numpy(a).bfloat16().float().numpy() for a in arrays]
    drop = DROP if masked else None
    want = _layer_vjp(thybrid.hybrid_propagate_layer, hg, arrays, thybrid.hybrid_masks(hg, drop),
                      lambda a: torch.from_numpy(a).to(dtype))
    before = ell_kernel.LAUNCHES["ell_gather_reduce"]
    on_card = hg.to(cuda)
    masks = thybrid.hybrid_masks(on_card, drop)
    runs = [_layer_vjp(thybrid.hybrid_propagate_layer, on_card, arrays, masks,
                       lambda a: torch.from_numpy(a).to(dtype).to(cuda)) for _ in range(2)]
    torch.cuda.synchronize()
    assert ell_kernel.LAUNCHES["ell_gather_reduce"] - before >= 8  # 2 fwd + 2 bwd, twice
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    got = runs[0]
    if dtype == torch.float32:
        for g, w in zip(got, want):
            torch.testing.assert_close(g.cpu(), w, atol=ATOL, rtol=0)
        return
    exact, limits = _bf16_reference(td, arrays, drop)
    for g, w, e, limit in zip(got, want, exact, limits):
        assert g.dtype == torch.bfloat16
        assert (np.abs(g.cpu().float().numpy() - e) <= limit).all()
        assert (np.abs(w.float().numpy() - e) <= limit).all()
