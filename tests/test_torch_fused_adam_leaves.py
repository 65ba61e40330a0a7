"""The fused Adam over every leaf of a step (`gsrs_tpu_torch.train.fused_adam`):
the kernel's leaf table (chunks, launches of at most 64 leaves, alignment,
missing gradients) as plain Python and torch; `FusedAdam(backend="pallas")`
over NGCF's leaf shapes with mixed fp32/bf16 leaves and a leaf without a
gradient, step for step against JAX's `FusedAdam(backend="pallas")` (its
Pallas kernel in interpret mode on the CPU); a checkpoint round trip; and
(marked ``gpu``, on a CUDA card only) the multi-leaf kernel bitwise against
its plain version, one launch per step."""

import io
import math

import numpy as np
import pytest
import torch

from gsrs_tpu_torch import config as tcfg
from gsrs_tpu_torch.train import fused_adam as tfa
from gsrs_tpu_torch.train.optim import (load_optimizer_state, lr_schedule,
                                        optimizer_state_dict)

ADAM_ATOL = 2e-6  # fp32 Adam trajectories (lr ≤ 1e-2) over a few steps, as test_torch_train
BF16_RTOL, BF16_ATOL = 1e-2, 1e-3  # bf16 leaves against JAX, as test_torch_train
SCHED_KW = dict(lr=1e-2, use_scheduler=True, sched_milestones=(2,), sched_gamma=0.5)


def ngcf_shapes(n, m, d, layers=3):
    """An NGCF step's leaves: the two tables, then W1, W2, b1, b2 a layer."""
    return [(n, d), (m, d)] + [s for _ in range(layers) for s in ((d, d), (d, d), (d,), (d,))]


def _leaves(shapes, dtypes, device="cpu"):
    """(p, m, v) of each shape, contiguous, on ``device``."""
    out = []
    for s, dt in zip(shapes, dtypes):
        out.append(tuple(torch.zeros(s, dtype=dt, device=device) for _ in range(3)))
    return out


# ------------------------------------------------------------- the leaf table


C = tfa.CHUNK


@pytest.mark.parametrize("shapes", [
    [(37, 11), (0,), (5,), (64, 64), (8,), (3, 0), (1000,), (2 * C + 3,)],
    [(C,), (C - 1,), (C + 1,), (1,), (2, C), (3 * C - 8,)],  # around chunk boundaries
    [(0,), (0, 4)] + [(C // 2, 3)] * 6,  # empty leaves first, then leaves of 1.5 chunks
])
def test_chunks_cover_every_element_once_in_leaf_order(shapes):
    """Each leaf's entry holds its size and its first chunk; the next
    leaf's first chunk follows its ⌈n/CHUNK⌉ chunks, so the kernel's
    chunks cover every element once, in leaf order, never crossing a leaf."""
    leaves = _leaves(shapes, [torch.float32] * len(shapes))
    plan = tfa.LeafPlan(leaves)
    (table, n_leaves), = plan.tables
    assert n_leaves == len(shapes)
    entries = [table.leaf[i] for i in range(n_leaves)]
    assert [e.n for e in entries] == [math.prod(s) for s in shapes]
    assert [e.p or 0 for e in entries] == [p.data_ptr() for p, _, _ in leaves]  # None: null
    chunk0 = [e.chunk0 for e in entries] + [table.n_chunks]
    assert chunk0[0] == 0
    assert [b - a for a, b in zip(chunk0, chunk0[1:])] == [math.ceil(e.n / C) for e in entries]
    assert table.n_chunks == sum(math.ceil(math.prod(s) / C) for s in shapes)


@pytest.mark.parametrize("n_leaves,launches", [(1, 1), (64, 1), (65, 2), (70, 2), (129, 3)])
def test_more_than_64_leaves_split_into_launches(n_leaves, launches):
    shapes = [(i % 7 + 1, 3) for i in range(n_leaves)]
    plan = tfa.LeafPlan(_leaves(shapes, [torch.float32] * n_leaves))
    assert len(plan.tables) == launches
    assert [n for _, n in plan.tables] == [min(64, n_leaves - 64 * k) for k in range(launches)]
    for table, n in plan.tables:
        assert table.leaf[0].chunk0 == 0  # each launch's chunks start afresh
        assert table.n_chunks == n  # every leaf here is one chunk


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_alignment_flag_follows_data_ptr(dtype):
    base = torch.zeros(37 * 11 + 1, dtype=dtype)
    view = base[1:].view(37, 11)  # storage offset 1: 4 or 2 bytes past a 16-byte boundary
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    whole = torch.zeros(37, 11, dtype=dtype)
    plan = tfa.LeafPlan([(whole, torch.zeros_like(whole), torch.zeros_like(whole)),
                         (view, torch.zeros_like(view), torch.zeros_like(view))])
    entries = [plan.tables[0][0].leaf[i] for i in range(2)]
    bf16 = tfa.BF16 if dtype == torch.bfloat16 else 0
    assert [e.flags for e in entries] == [tfa.ALIGNED | bf16, bf16]
    g_off = torch.zeros(37 * 11 + 1, dtype=dtype)[1:].view(37, 11)
    plan.fill([g_off, torch.zeros(37, 11, dtype=dtype)])  # an unaligned gradient, this step
    assert [e.flags for e in entries] == [bf16, bf16]
    plan.fill([torch.zeros(37, 11, dtype=dtype), None])
    assert [e.flags for e in entries] == [tfa.ALIGNED | bf16, bf16]


def test_missing_grad_gives_null_g():
    shapes = [(4, 8), (8,), (3, 3)]
    plan = tfa.LeafPlan(_leaves(shapes, [torch.float32, torch.bfloat16, torch.float32]))
    grads = [torch.ones(4, 8), None, torch.ones(3, 3)]
    plan.fill(grads)
    table = plan.tables[0][0]
    assert table.leaf[0].g == grads[0].data_ptr() and table.leaf[2].g == grads[2].data_ptr()
    assert table.leaf[1].g is None  # null: the kernel reads no gradient and takes +0
    plan.fill([None, None, None])
    assert all(table.leaf[i].g is None for i in range(3))


def test_plan_refuses_what_the_kernel_does_not_take():
    p = torch.zeros(8, 4)
    with pytest.raises(TypeError):
        tfa.LeafPlan([(p.double(), p.double(), p.double())])
    with pytest.raises(TypeError):
        tfa.LeafPlan([(p, p.bfloat16(), p.clone())])
    with pytest.raises(ValueError, match="contiguous"):
        tfa.LeafPlan([(p.T, p.T.clone(), p.T.clone())])
    with pytest.raises(ValueError, match="shape"):
        tfa.LeafPlan([(p, torch.zeros(4, 8), p.clone())])
    plan = tfa.LeafPlan([(p, p.clone(), p.clone())])
    with pytest.raises(TypeError):
        plan.fill([p.bfloat16()])
    with pytest.raises(ValueError, match="contiguous"):
        plan.fill([torch.zeros(4, 8).T])
    with pytest.raises(ValueError, match="gradients"):
        plan.fill([p, p])
    with pytest.raises(ValueError, match="CUDA tensors"):  # no CPU mode: the CPU takes _adam_math
        plan.launch([p], 1e-3, 10.0, 1000.0, tfa._consts(0.9, 0.999, 1e-8))


def test_plan_is_kept_until_its_tensors_change():
    opt = tfa.FusedAdam(schedule=lambda c: 1e-2, backend="pallas")
    params = {k: torch.nn.Parameter(torch.randn(s)) for k, s in (("a", (5, 4)), ("b", (3,)))}
    state = opt.init(params)
    plan = opt.plan(params, state)
    assert opt.plan(params, tfa.FusedAdamState(0, state.mu, state.nu, plan)) is plan
    restored = load_optimizer_state(opt, params, optimizer_state_dict(state, params))
    assert restored.plan is None and opt.plan(params, restored) is not plan
    params["a"].data = torch.randn(5, 4)  # the parameter moved: new tables
    assert opt.plan(params, tfa.FusedAdamState(0, state.mu, state.nu, plan)) is not plan


@pytest.mark.parametrize("change", ["shape", "dtype"])
def test_plan_is_not_reused_for_a_parameter_changed_at_the_same_address(change):
    """A parameter replaced by a tensor of another shape or dtype at the
    same address (as a caching allocator may hand out) must not reuse
    tables built for the old one, whose size would run past its end; its
    moments no longer fit it, so the new tables are refused."""
    opt = tfa.FusedAdam(schedule=lambda c: 1e-2, backend="pallas")
    storage = torch.zeros(64)
    params = {"a": torch.nn.Parameter(storage[:20].view(5, 4)),
              "b": torch.nn.Parameter(torch.zeros(3))}
    state = opt.init(params)
    kept = tfa.FusedAdamState(0, state.mu, state.nu, opt.plan(params, state))
    assert opt.plan(params, kept) is kept.plan
    params["a"].data = (storage.view(8, 8) if change == "shape"
                        else storage[:10].view(torch.bfloat16).view(5, 4))
    assert params["a"].data_ptr() == kept.plan.p_ptrs[0]
    assert not kept.plan.matches(list(params.values()), list(state.mu.values()),
                                 list(state.nu.values()))
    with pytest.raises(ValueError if change == "shape" else TypeError):
        opt.plan(params, kept)


def test_leaves_wrapper_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(0)
    shapes, dtypes = [(6, 5), (7,), (3, 3)], [torch.float32, torch.bfloat16, torch.float32]
    leaves = [tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dt)
                    for _ in range(4)) for s, dt in zip(shapes, dtypes)]
    for _, m, v, _ in leaves:
        v.abs_()
    want = [tuple(t.clone() for t in leaf) for leaf in leaves]
    args = (1e-2, 10.0, 1000.0, 0.9, 0.999, 1e-8)
    tfa.fused_adam_leaves_([(p, m, v, None if i == 1 else g)
                            for i, (p, m, v, g) in enumerate(leaves)], *args)
    for i, (p, m, v, g) in enumerate(want):
        tfa._adam_math_(p, m, v, torch.zeros_like(g) if i == 1 else g, *args)
    for got, ref in zip(leaves, want):
        for a, b in zip(got[:3], ref[:3]):
            assert torch.equal(a, b)
    p = torch.zeros(3)
    with pytest.raises(ValueError, match="shape"):
        tfa.fused_adam_leaves_([(p, p.clone(), p.clone(), torch.zeros(4))], *args)


# ---------------------------------------------------- against JAX's fused Adam


def _step_inputs(shapes, dtypes, steps, seed, missing):
    """numpy parameters and per-step gradients (None for ``missing``)."""
    rng = np.random.default_rng(seed)
    params = [(0.1 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    grads = [[None if i == missing else rng.standard_normal(s).astype(np.float32)
              for i, s in enumerate(shapes)] for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("missing", [1, 6])  # an item table, a layer's bias
def test_step_matches_jax_pallas_step_for_step(missing):
    jax = pytest.importorskip("jax", reason="the JAX package is the reference")
    import jax.numpy as jnp

    from gsrs_tpu.config import TrainConfig as JaxTrainConfig
    from gsrs_tpu.train.fused_adam import FusedAdam as JaxFusedAdam
    from gsrs_tpu.train.optim import lr_schedule as jax_schedule

    shapes = ngcf_shapes(30, 40, 8)
    dtypes = [torch.float32, torch.bfloat16] + [torch.float32, torch.bfloat16] * 6
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    names = [f"leaf{i}" for i in range(len(shapes))]
    params_np, grads_np = _step_inputs(shapes, dtypes, 3, seed=4, missing=missing)

    opt = tfa.FusedAdam(schedule=lr_schedule(tcfg.TrainConfig(**SCHED_KW), 1), backend="pallas")
    # copies: on the CPU jnp.asarray may share the numpy buffers the port updates in place
    params = {k: torch.nn.Parameter(torch.tensor(v).to(dt))
              for k, v, dt in zip(names, params_np, dtypes)}
    state = opt.init(params)
    jopt = JaxFusedAdam(schedule=jax_schedule(JaxTrainConfig(**SCHED_KW), 1), backend="pallas")
    assert jopt.interpret  # the Pallas kernel, interpreted on the CPU
    jp = {k: jnp.asarray(v, jdt[dt]) for k, v, dt in zip(names, params_np, dtypes)}
    js = jopt.init(jp)
    for step_grads in grads_np:
        for k, g, dt in zip(names, step_grads, dtypes):
            params[k].grad = None if g is None else torch.from_numpy(g).to(dt)
        state = opt.step(params, state)
        jg = {k: jnp.zeros(s, jdt[dt]) if g is None else jnp.asarray(g, jdt[dt])
              for k, s, dt, g in zip(names, shapes, dtypes, step_grads)}
        jp, js = jopt.step(jp, jg, js)
        for k, dt in zip(names, dtypes):
            tol = (dict(atol=ADAM_ATOL, rtol=0) if dt == torch.float32
                   else dict(atol=BF16_ATOL, rtol=BF16_RTOL))
            for got, want in ((params[k], jp[k]), (state.mu[k], js.mu[k]),
                              (state.nu[k], js.nu[k])):
                assert got.dtype == dt
                np.testing.assert_allclose(got.detach().float().numpy(),
                                           np.asarray(want, np.float32), **tol, err_msg=k)
    assert state.count == 3 and all(p.grad is None for p in params.values())


# ------------------------------------------------------------ checkpoint round trip


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ with no CPU mode")
    return torch.device("cuda:0")


def _device(name, request):
    return request.getfixturevalue("cuda") if name == "cuda" else torch.device("cpu")


def _grads_for(params, step, missing=None):
    g = torch.Generator().manual_seed(100 + step)
    return {k: None if k == missing else torch.randn(p.shape, generator=g).to(p.device, p.dtype)
            for k, p in params.items()}


def _set_grads(params, grads):
    for k, p in params.items():
        p.grad = None if grads[k] is None else grads[k].clone()


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_checkpoint_round_trip_is_bitwise(device, request):
    dev = _device(device, request)
    opt = tfa.FusedAdam(schedule=lr_schedule(tcfg.TrainConfig(**SCHED_KW), 1), backend="pallas")
    g = torch.Generator().manual_seed(0)
    shapes = ngcf_shapes(30, 40, 8)
    params = {f"leaf{i}": torch.nn.Parameter(
        torch.randn(s, generator=g).to(dev, torch.bfloat16 if i % 3 == 2 else torch.float32))
        for i, s in enumerate(shapes)}
    state = opt.init(params)
    for step in range(2):
        _set_grads(params, _grads_for(params, step, missing="leaf5"))
        state = opt.step(params, state)
    saved_params = {k: p.detach().clone() for k, p in params.items()}
    buf = io.BytesIO()  # as a checkpoint holds it: a copy, not the live moments
    torch.save(optimizer_state_dict(state, params), buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    _set_grads(params, _grads_for(params, 2))
    unbroken = opt.step(params, state)

    restored_params = {k: torch.nn.Parameter(v) for k, v in saved_params.items()}
    restored = load_optimizer_state(opt, restored_params, saved)
    _set_grads(restored_params, _grads_for(restored_params, 2))
    resumed = opt.step(restored_params, restored)
    assert resumed.count == unbroken.count == 3
    for k in params:
        assert torch.equal(restored_params[k], params[k])
        assert torch.equal(resumed.mu[k], unbroken.mu[k])
        assert torch.equal(resumed.nu[k], unbroken.nu[k])


# ----------------------------------------------------------------- on the card


def _card_tables(dev):
    """name → [(p0, steps' grads)] of the tables the card cases run."""
    g = torch.Generator(device=dev).manual_seed(0)

    def leaf(shape, dtype, p=None):
        p = (0.1 * torch.randn(shape, device=dev, generator=g)).to(dtype) if p is None else p
        return p, [torch.randn(shape, device=dev, generator=g).to(dtype) for _ in range(3)]

    base = torch.zeros(37 * 11 + 1, device=dev)
    base[1:] = 0.1 * torch.randn(37 * 11, device=dev, generator=g)
    mixed = [leaf(s, torch.bfloat16 if i % 2 else torch.float32)
             for i, s in enumerate(ngcf_shapes(300, 401, 64))]
    return {
        "mixed": mixed + [leaf((37, 11), torch.bfloat16), leaf((0,), torch.float32),
                          leaf((9000,), torch.float32)],
        "offset_view": [leaf((37, 11), torch.float32, base[1:].view(37, 11)),
                        leaf((64, 64), torch.float32)],
        "70_leaves": [leaf((i % 9 + 1, 5 + i % 4), torch.float32 if i % 3 else torch.bfloat16)
                      for i in range(70)],
    }


@pytest.mark.gpu
@pytest.mark.parametrize("table", ["mixed", "offset_view", "70_leaves"])
def test_multi_leaf_kernel_is_bitwise_the_plain_version(cuda, table):
    """Three steps across a milestone: the kernel and `_adam_math` on the
    same card tensors, equal bit for bit; ⌈leaves/64⌉ launches a step."""
    sched = lr_schedule(tcfg.TrainConfig(**SCHED_KW), 1)
    runs = []
    for backend in ("pallas", "jnp"):
        leaves = _card_tables(cuda)[table]  # the same values for each run, the view's included
        params = {f"leaf{i}": torch.nn.Parameter(p0) for i, (p0, _) in enumerate(leaves)}
        opt = tfa.FusedAdam(schedule=sched, backend=backend)
        state = opt.init(params)
        before = tfa.LAUNCHES["fused_adam"]
        for step in range(3):
            for (k, p), (_, grads) in zip(params.items(), leaves):
                p.grad = None if (k == "leaf3" and step == 1) else grads[step].clone()
            state = opt.step(params, state)
        launched = tfa.LAUNCHES["fused_adam"] - before
        assert launched == (3 * math.ceil(len(leaves) / 64) if backend == "pallas" else 0)
        torch.cuda.synchronize()
        runs.append([(p.detach(), state.mu[k], state.nu[k]) for k, p in params.items()])
    for got, want in zip(*runs):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.gpu
def test_one_launch_per_step_through_fused_adam_step(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    params = {f"leaf{i}": torch.nn.Parameter(torch.randn(s, device=cuda, generator=g))
              for i, s in enumerate(ngcf_shapes(300, 401, 64))}
    opt = tfa.FusedAdam(schedule=lambda c: 1e-3, backend="pallas")
    state = opt.init(params)
    plans = []
    for _ in range(4):
        for p in params.values():
            p.grad = torch.randn_like(p)
        before = tfa.LAUNCHES["fused_adam"]
        state = opt.step(params, state)
        assert tfa.LAUNCHES["fused_adam"] - before == 1
        plans.append(state.plan)
    assert all(pl is plans[0] for pl in plans)  # built once, its gradient pointers refilled
    torch.cuda.synchronize()
    assert all(torch.isfinite(p).all() for p in params.values())


@pytest.mark.gpu
def test_leaves_wrapper_rejects_what_it_does_not_take(cuda):
    p = torch.zeros(8, 4, device=cuda)
    args = (1e-2, 10.0, 1000.0, 0.9, 0.999, 1e-8)
    ok = (torch.zeros(3, device=cuda),) * 4
    with pytest.raises(TypeError):
        tfa.fused_adam_leaves_([ok, (p, p.clone(), p.clone(), p.double())], *args)
    with pytest.raises(TypeError):
        tfa.fused_adam_leaves_([(p.half(), p.half(), p.half(), p.half())], *args)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.fused_adam_leaves_([ok, (p.T, p.T.clone(), p.T.clone(), None)], *args)
    with pytest.raises(ValueError, match="different devices"):
        tfa.fused_adam_leaves_([ok, (p, p.clone(), p.clone(), p.cpu())], *args)
    with pytest.raises(ValueError, match="different devices"):
        tfa.fused_adam_leaves_([(p.cpu(), p.cpu(), p.cpu(), None), ok], *args)
