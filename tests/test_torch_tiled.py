"""The port's tiled layout (`gsrs_tpu_torch.ops.tiled`) against the JAX
package's on JAX-CPU: the builder array for array (dense blocks in fp32
and in bf16 bits, hub columns, orders, the ``occ`` and residual buckets),
the memory guard, one tiled layer forward and VJP with and without the
hash mask (against JAX's tiled layer and the port's own ELL layer), a
3-step bf16 training step through `Trainer.run_steps` against the JAX
trainer on the ELL and tiled layouts, and LightGCN's tiled layout built
from the graph. Cases marked ``gpu`` run the layer on a CUDA card."""

import dataclasses

import numpy as np
import pytest
import torch

from gsrs_tpu_torch import config as tcfg
from gsrs_tpu_torch.data import adjacency as tadj
from gsrs_tpu_torch.data import synthetic as tsyn
from gsrs_tpu_torch.ops import ell as tell
from gsrs_tpu_torch.ops import tiled as ttiled

CPU = "cpu"
ATOL = 1e-5  # fp32: sums of O(1) in another order
# bf16: each package is within k roundings to bf16 (2^-8 relative each) of the fp32 result
# of the rounded inputs, k = 2 forward (hub product or residual, then their sum) and 3
# backward (hub cotangent, occ sum, then the sum with the residual), scaled by sum |w| |x|;
# two such results differ by at most twice that
BF16_ROUNDINGS = {"forward": 2, "backward": 3}
BF16_ATOL = 1e-6
CASES = [(1, 8), (4, 16), (8, 96), (4, 8192)]  # tests/test_tiled.py's (groups, cols)


@pytest.fixture
def jax():
    return pytest.importorskip("jax", reason="the JAX package is the reference these tests "
                               "compare with")


def _data(seed=3):
    from gsrs_tpu.data.synthetic import clustered

    return clustered(64, 96, n_clusters=4, seed=seed), tsyn.clustered(64, 96, n_clusters=4,
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
    """Every array of an EllSide (JAX's or the port's) as numpy."""
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


@pytest.mark.parametrize("groups,cols", CASES)
@pytest.mark.parametrize("bf16", [False, True])
def test_builder_is_the_jax_layout(jax, groups, cols, bf16):
    import jax.numpy as jnp

    from gsrs_tpu.ops.tiled import tiled_from_interactions as jtiled

    jd, td = _data()
    jg = jtiled(jd, groups=groups, cols=cols, dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tg = ttiled.tiled_from_interactions(td, groups=groups, cols=cols,
                                        dtype=torch.bfloat16 if bf16 else torch.float32)
    assert (tg.n_users, tg.m_items) == (jg.n_users, jg.m_items)
    for name in ("user_from_item", "item_from_user"):
        j, t = getattr(jg, name), getattr(tg, name)
        assert (t.groups, t.rows_g, t.cols) == (j.groups, j.rows_g, j.cols)
        if bf16:
            assert t.dense.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.dense.view(torch.int16).numpy(),
                                          np.asarray(j.dense).view(np.int16))
        else:
            assert t.dense.dtype == torch.float32
            np.testing.assert_array_equal(t.dense.numpy(), np.asarray(j.dense))
        for f in ("top_src", "order_dst", "row_nat"):
            np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))
        _assert_sides_equal(t.occ, j.occ)
        _assert_sides_equal(t.residual.by_user, j.residual.by_user)
        _assert_sides_equal(t.residual.by_item, j.residual.by_item)
        # the residual's canonical edge list, in eidx order, is what its slots hold
        n_res = t.res_dst.numel()
        assert n_res == sum(int((np.asarray(b.w) != 0).sum()) for b in j.residual.by_user.buckets)
        for b in t.residual.by_user.buckets:
            real = b.w != 0
            rows = b.rows[:, None].expand_as(b.cols)[real]
            np.testing.assert_array_equal(t.res_dst[b.eidx[real].long()].numpy(), rows.numpy())
            np.testing.assert_array_equal(t.res_src[b.eidx[real].long()].numpy(),
                                          b.cols[real].numpy())


def test_memory_guard_clamps_and_degenerates_to_ell(jax):
    jd, td = _data()
    with pytest.warns(UserWarning, match="clamping to C="):
        tg = ttiled.tiled_from_interactions(td, groups=2, cols=8192, hbm_budget_gb=1e-7)
    assert tg.user_from_item.dense.shape[1] == 0 and tg.user_from_item.cols == 0
    rng = np.random.default_rng(3)
    u, x = (torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32)) for n in (64, 96))
    ell = tell.ell_from_interactions(td)
    for got, want in zip(ttiled.tiled_propagate_layer(tg, u, x),
                         tell.ell_propagate_layer(ell, u, x)):
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    # the clamp warns from the port's guard as from JAX's, with the same numbers
    from gsrs_tpu.ops.hybrid import resolve_hybrid_cols as jresolve
    from gsrs_tpu_torch.ops.hybrid import resolve_hybrid_cols

    with pytest.warns(UserWarning, match="clamping to C=256") as ours:
        assert resolve_hybrid_cols(30000, 40000, 8192, torch.bfloat16, 0.04) == 256
    with pytest.warns(UserWarning) as theirs:
        jresolve(30000, 40000, 8192, np.float16, 0.04)
    assert str(ours[0].message) == str(theirs[0].message)
    assert resolve_hybrid_cols(30000, 40000, 2048, torch.float32) == 2048


def _layer_vjp(layer, graph, arrays, drop, to):
    """(new_u, new_i, d_user, d_item) of the port's layer."""
    u, x, gu, gx = (to(a) for a in arrays)
    u, x = u.requires_grad_(), x.requires_grad_()
    nu, ni = layer(graph, u, x, drop)
    torch.autograd.backward((nu, ni), (gu, gx))
    return nu.detach(), ni.detach(), u.grad, x.grad


def _jax_layer_vjp(tg, arrays, drop, dtype):
    import jax
    import jax.numpy as jnp

    from gsrs_tpu.ops.tiled import tiled_propagate_layer

    u, x, gu, gx = (jnp.asarray(a, dtype) for a in arrays)
    (nu, ni), vjp = jax.vjp(lambda a, b: tiled_propagate_layer(tg, a, b, drop), u, x)
    du, dx = vjp((gu, gx))
    return tuple(np.asarray(a.astype(jnp.float32)) for a in (nu, ni, du, dx))


def _arrays(seed=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, 8)).astype(np.float32) for n in (64, 96, 64, 96)]


DROP = (0x2545F491, 0x9E3779B9, 0.7)  # one key word above 2**31


def _drops(masked):
    import jax.numpy as jnp

    if not masked:
        return None, None
    return DROP, (jnp.uint32(DROP[0]), jnp.uint32(DROP[1]), jnp.float32(DROP[2]))


@pytest.mark.parametrize("masked", [False, True])
def test_layer_matches_jax_and_ell_fp32(jax, masked):
    """Forward and VJP, 1e-5: against JAX's tiled layer on the same
    layout, and against the port's ELL layer with the same edges kept
    (the hash mask in canonical edge order)."""
    from gsrs_tpu.ops.tiled import tiled_from_interactions as jtiled

    jd, td = _data()
    tg = ttiled.tiled_from_interactions(td, groups=4, cols=24)
    tdrop, jdrop = _drops(masked)
    arrays = _arrays()
    got = _layer_vjp(ttiled.tiled_propagate_layer, tg, arrays, ttiled.tiled_masks(tg, tdrop),
                     torch.from_numpy)
    want = _jax_layer_vjp(jtiled(jd, groups=4, cols=24), arrays, jdrop, np.float32)
    ell = tell.ell_from_interactions(td)
    mask = None
    if masked:
        from gsrs_tpu_torch.ops.hashdrop import canonical_hash_mask

        mask = canonical_hash_mask(torch.from_numpy(td.train_users),
                                   torch.from_numpy(td.train_items), tdrop)
        assert 0 < float((mask == 0).float().mean()) < 1
    via_ell = _layer_vjp(tell.ell_propagate_layer, ell, arrays, mask, torch.from_numpy)
    for g, w, e in zip(got, want, via_ell):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0)
        np.testing.assert_allclose(g.numpy(), e.numpy(), atol=ATOL, rtol=0)


def _bf16_reference(td, arrays, drop):
    """(exact, limit) for a bf16 tiled layer's (new_u, new_i, d_user,
    d_item) on the bf16 values ``arrays``: the port's ELL layer in fp32
    with the bf16-rounded weights (and the hash mask in canonical order),
    and the BF16_ROUNDINGS limit around it, scaled by the same layer on
    |weights| and |inputs|. With a mask the dense cells hold
    round(round(w) · round(mask)): two more roundings."""
    from gsrs_tpu_torch.ops.hashdrop import canonical_hash_mask

    ell = tell.ell_from_interactions(td)
    rounded = dataclasses.replace(ell, **{s: dataclasses.replace(getattr(ell, s), buckets=tuple(
        dataclasses.replace(b, w=b.w.bfloat16().float()) for b in getattr(ell, s).buckets))
        for s in ("by_user", "by_item")})
    mask = canonical_hash_mask(torch.from_numpy(td.train_users),
                               torch.from_numpy(td.train_items), drop)
    exact = _layer_vjp(tell.ell_propagate_layer, rounded, arrays, mask, torch.from_numpy)
    mag = _layer_vjp(tell.ell_propagate_layer, rounded, [np.abs(a) for a in arrays], mask,
                     torch.from_numpy)
    limits = []
    for i, m in enumerate(mag):
        k = BF16_ROUNDINGS["forward" if i < 2 else "backward"] + 2 * int(drop is not None)
        limits.append(((1 + 2.0**-8) ** k - 1) * m.numpy() + BF16_ATOL)
    return [e.numpy() for e in exact], limits


@pytest.mark.parametrize("masked", [False, True])
def test_layer_matches_jax_bf16(jax, masked):
    """bf16 forward and VJP against JAX's bf16 tiled layer, within twice
    the rounding limit of each (BF16_ROUNDINGS), and both within it of the
    fp32 result of the rounded inputs (`_bf16_reference`)."""
    import jax.numpy as jnp

    from gsrs_tpu.ops.tiled import tiled_from_interactions as jtiled

    jd, td = _data()
    tg = ttiled.tiled_from_interactions(td, groups=4, cols=24, dtype=torch.bfloat16)
    tdrop, jdrop = _drops(masked)
    arrays = [a.astype(jnp.bfloat16).astype(np.float32) for a in _arrays(5)]
    got = _layer_vjp(ttiled.tiled_propagate_layer, tg, arrays, ttiled.tiled_masks(tg, tdrop),
                     lambda a: torch.from_numpy(a).bfloat16())
    assert all(g.dtype == torch.bfloat16 for g in got)
    want = _jax_layer_vjp(jtiled(jd, groups=4, cols=24, dtype=jnp.bfloat16), arrays, jdrop,
                          jnp.bfloat16)
    exact, limits = _bf16_reference(td, arrays, tdrop)
    for g, w, e, limit in zip(got, want, exact, limits):
        g = g.float().numpy()
        assert (np.abs(g - e) <= limit).all()
        assert (np.abs(w - e) <= limit).all()
        assert (np.abs(g - w) <= 2 * limit).all()


def _bf16_trainers(jax, tmp_path, layout):
    from gsrs_tpu.config import (
        EvalConfig as JEval, ExperimentConfig as JExp, ModelConfig as JModel,
        TrainConfig as JTrain,
    )
    from gsrs_tpu.data.adjacency import build_graph as jbuild_graph
    from gsrs_tpu.models.registry import build_model as jbuild_model
    from gsrs_tpu.ops.ell import ell_from_interactions as jell
    from gsrs_tpu.ops.tiled import tiled_from_interactions as jtiled
    from gsrs_tpu.train.trainer import Trainer as JTrainer
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.train.trainer import Trainer

    import jax.numpy as jnp

    jd, td = _data()
    model_kw = dict(num_layers=3, embedding_dim=8, bf16_compute=True, spmm_mode=layout,
                    tiled_groups=4, tiled_cols=24)
    train_kw = dict(batch_size=64, lr=1e-2, decay=1e-3, fused_adam="off", neg_candidates=4)
    jcfg = JExp(model=JModel(**model_kw),
                train=JTrain(checkpoint_dir=str(tmp_path), tensorboard=False, **train_kw),
                eval=JEval(test_batch=32, topks=(10,)))
    jgraph = jbuild_graph(jd, edge_pad_multiple=256)
    jlayout = (jtiled(jd, groups=4, cols=24, dtype=jnp.bfloat16) if layout == "tiled"
               else jell(jd))
    jtr = JTrainer(jcfg, jd, jgraph, jbuild_model(jcfg.model, jgraph, ell=jlayout),
                   run_eval=False)
    cfg = tcfg.ExperimentConfig(model=tcfg.ModelConfig(**model_kw),
                                train=tcfg.TrainConfig(**train_kw),
                                eval=tcfg.EvalConfig(test_batch=32, topks=(10,)))
    tgraph = tadj.build_graph(td, edge_pad_multiple=256)
    tlayout = (ttiled.tiled_from_interactions(td, groups=4, cols=24, dtype=torch.bfloat16)
               if layout == "tiled" else tell.ell_from_interactions(td))
    ttr = Trainer(cfg, td, tgraph, build_model(cfg.model, tgraph, ell=tlayout, device=CPU),
                  run_eval=False, device=CPU)
    return jtr, ttr


# bf16 training, 3 Adam steps at lr 1e-2 from the same fp32 parameters: the two packages'
# layers round to bf16 in other orders, so their gradients differ by about one bf16 rounding
# (2^-8 relative). Adam's step m/sqrt(v) hardly moves with that, except where a gradient
# component sits at the rounding noise, where its sign may differ (up to 2 lr a step). So:
# losses within 2^-8 relative; at most 1% of the parameters differ by more than 1e-4 (the
# per-step effect of a 2^-8 change, lr·2^-8 ≈ 4e-5, over the steps); none by more than
# 2 lr a step.
LOSS_RTOL = 2.0**-8
PARAM_ATOL, PARAM_SHARE = 1e-4, 1e-2


@pytest.mark.parametrize("layout", ["ell", "tiled"])
def test_bf16_run_steps_match_the_jax_trainer(jax, tmp_path, layout):
    """fp32 parameters, bf16 layers, Adam "off" (optax.adam / torch.optim.Adam):
    both trainers take the same three steps from the JAX initial parameters."""
    import jax.numpy as jnp

    from gsrs_tpu_torch.convert import params_from_jax

    jtr, ttr = _bf16_trainers(jax, tmp_path, layout)
    assert isinstance(ttr.model.ell, ttiled.TiledGraph) == (layout == "tiled")
    epoch_fn = jtr._build_epoch_fn()
    state = jtr.init_state()
    params, opt_state = state.params, state.opt_state
    params_np = jax.tree.map(np.asarray, params)
    tstate = ttr.init_state()
    ttr.model.load_state_dict(params_from_jax(params_np, ttr.cfg.model, CPU))
    rng = np.random.default_rng(9)
    batch = tuple(rng.integers(0, n, (3, 64)) for n in (64, 96, 96))
    jlosses = []
    for s in range(3):
        u, p, n = (jnp.asarray(a[s:s + 1], jnp.int32) for a in batch)
        keys = jax.random.split(jax.random.key(0), 1)
        params, opt_state, loss = epoch_fn(params, opt_state, jtr.graph, jtr.model.ell,
                                           u, p, n, keys)
        jlosses.append(float(loss))
    tstate, tlosses = ttr.run_steps(tstate, *batch)
    assert all(p.dtype == torch.float32 for p in ttr.model.parameters())
    np.testing.assert_allclose(tlosses.numpy(), jlosses, rtol=LOSS_RTOL)
    want = params_from_jax(jax.tree.map(np.asarray, params), ttr.cfg.model, CPU)
    diff = torch.cat([(p.detach() - want[k]).abs().reshape(-1)
                      for k, p in ttr.model.named_parameters()])
    assert float(diff.max()) <= 2 * 3 * 1e-2
    assert float((diff > PARAM_ATOL).float().mean()) <= PARAM_SHARE


def test_lightgcn_tiled_from_graph_equals_from_data():
    """`LightGCN(spmm_mode="tiled")` rebuilds its layout from the graph's
    padded edge arrays: the same layout as `tiled_from_interactions`."""
    from gsrs_tpu_torch.models.registry import build_model

    td = tsyn.powerlaw(120, 150, avg_degree=5, seed=4)
    graph = tadj.build_graph(td, edge_pad_multiple=256)
    cfg = tcfg.ModelConfig(num_layers=2, embedding_dim=8, spmm_mode="tiled", tiled_groups=4,
                           tiled_cols=32, bf16_compute=True)
    model = build_model(cfg, graph, device=CPU)
    want = ttiled.tiled_from_interactions(td, groups=4, cols=32, dtype=torch.bfloat16)
    for name in ("user_from_item", "item_from_user"):
        a, b = getattr(model.ell, name), getattr(want, name)
        assert a.dense.dtype == torch.bfloat16
        for f in ("dense", "top_src", "order_dst", "row_nat", "res_dst", "res_src"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        _assert_sides_equal(a.occ, b.occ)
        _assert_sides_equal(a.residual.by_user, b.residual.by_user)
        _assert_sides_equal(a.residual.by_item, b.residual.by_item)


def test_tiled_dropout_uses_one_hash_mask_per_propagation():
    """With cfg.dropout, `propagate` draws one HashDrop from the generator
    and every layer uses the masks computed from it once; the masks are a
    function of the HashDrop alone (two computations are equal)."""
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.ops.hashdrop import hashdrop_from_generator

    td = tsyn.clustered(64, 96, seed=3)
    graph = tadj.build_graph(td, edge_pad_multiple=256)
    cfg = tcfg.ModelConfig(num_layers=2, embedding_dim=8, spmm_mode="tiled", tiled_groups=4,
                           tiled_cols=16, dropout=True, keep_prob=0.6)
    model = build_model(cfg, graph, device=CPU)
    drop = hashdrop_from_generator(torch.Generator().manual_seed(5), 0.6)
    masks = ttiled.tiled_masks(model.ell, drop)
    for a, b in zip(masks, ttiled.tiled_masks(model.ell, drop)):
        assert torch.equal(a.dense, b.dense) and torch.equal(a.residual, b.residual)
    with torch.no_grad():
        got = model.propagate(torch.Generator().manual_seed(5))
        cur = acc = (model.user_emb, model.item_emb)
        for _ in range(2):
            cur = ttiled.tiled_propagate_layer(model.ell, *cur, masks)
            acc = (acc[0] + cur[0], acc[1] + cur[1])
        plain = model.propagate()
    for a, b in zip(got, acc):
        torch.testing.assert_close(a, b / 3, atol=1e-6, rtol=0)
    assert not torch.allclose(got[0], plain[0])


def test_bench_builds_bench_py_configuration_and_runs_small(tmp_path):
    """`gsrs_tpu_torch.bench`: bench.py's configuration field for field,
    Gowalla when a directory holds train.txt and the stand-in otherwise,
    and one `Trainer.train_epoch` of that configuration (as
    ``chip_smoke.py`` runs it) on the CPU at a small size."""
    from gsrs_tpu_torch import bench
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.train.trainer import Trainer

    cfg = bench.bench_config()
    m, t = cfg.model, cfg.train
    assert (m.num_layers, m.embedding_dim, m.bf16_compute, m.spmm_mode, m.tiled_groups,
            m.tiled_cols) == (3, 64, True, "tiled", 64, 2048)
    assert (t.batch_size, t.neg_candidates, t.fused_adam, t.tensorboard) == (131072, 4, "off",
                                                                             False)
    assert not m.dropout and t.lr == 1e-3
    (tmp_path / "gowalla").mkdir()
    (tmp_path / "gowalla" / "train.txt").write_text("0 1 2\n1 0 2\n2 1\n")
    data, label, ddir = bench.gowalla_or_stand_in(str(tmp_path / "gowalla"))
    assert label == "gowalla" and ddir == str(tmp_path / "gowalla") and data.train_size == 5
    assert bench.gowalla_or_stand_in(str(tmp_path / "none"))[1:] == (bench.STAND_IN, None)

    small = dataclasses.replace(
        cfg, model=dataclasses.replace(m, embedding_dim=8, tiled_groups=4, tiled_cols=16),
        train=dataclasses.replace(t, batch_size=128))
    data = tsyn.powerlaw(200, 300, avg_degree=6, seed=1, holdout_frac=0.2)
    graph = tadj.build_graph(data)
    layout = ttiled.tiled_from_interactions(data, groups=4, cols=16, dtype=torch.bfloat16)
    model = build_model(small.model, graph, ell=layout, device=CPU)
    trainer = Trainer(small, data, graph, model, run_eval=False, device=CPU)
    state, loss = trainer.train_epoch(trainer.init_state())
    assert np.isfinite(loss) and state.epoch == 1
    assert trainer.steps_per_epoch == -(-data.train_size // 128)
    assert isinstance(model.ell, ttiled.TiledGraph)
    assert model.ell.user_from_item.dense.dtype == torch.bfloat16


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
    """The tiled layer forward and VJP on the card (K4 on every residual
    and occ side, which must launch) against the CPU's plain version:
    fp32 within 1e-5; bf16 both within the rounding limit of the fp32
    result of the rounded inputs (`_bf16_reference`), so within twice it
    of each other."""
    from gsrs_tpu_torch.ops import ell_kernel

    td = tsyn.powerlaw(300, 400, avg_degree=8, seed=2)
    tg = ttiled.tiled_from_interactions(td, groups=8, cols=64, dtype=dtype)
    rng = np.random.default_rng(7)
    arrays = [rng.standard_normal((k, 16)).astype(np.float32)
              for k in (td.n_users, td.m_items, td.n_users, td.m_items)]
    if dtype == torch.bfloat16:
        arrays = [torch.from_numpy(a).bfloat16().float().numpy() for a in arrays]
    drop = DROP if masked else None
    want = _layer_vjp(ttiled.tiled_propagate_layer, tg, arrays, ttiled.tiled_masks(tg, drop),
                      lambda a: torch.from_numpy(a).to(dtype))
    before = ell_kernel.LAUNCHES["ell_gather_reduce"]
    on_card = tg.to(cuda)
    got = _layer_vjp(ttiled.tiled_propagate_layer, on_card, arrays,
                     ttiled.tiled_masks(on_card, drop),
                     lambda a: torch.from_numpy(a).to(dtype).to(cuda))
    torch.cuda.synchronize()
    assert ell_kernel.LAUNCHES["ell_gather_reduce"] - before >= 6  # 2 fwd, 2 residual + 2 occ bwd
    if dtype == torch.float32:
        for g, w in zip(got, want):
            torch.testing.assert_close(g.cpu(), w, atol=ATOL, rtol=0)
        return
    exact, limits = _bf16_reference(td, arrays, drop)
    for g, w, e, limit in zip(got, want, exact, limits):
        assert g.dtype == torch.bfloat16
        assert (np.abs(g.cpu().float().numpy() - e) <= limit).all()
        assert (np.abs(w.float().numpy() - e) <= limit).all()
