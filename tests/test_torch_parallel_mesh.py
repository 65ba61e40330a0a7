"""The mesh and its collectives (`gsrs_tpu_torch.parallel.mesh`,
`...collectives`): the row-major rank grid, the explicit backend choice,
`distributed_init`'s reading of the launcher's environment (a partial
explicit configuration raises, as the JAX package's does), and, on four
gloo ranks spawned on the CPU (a 2 × 2 mesh), the autograd collectives
under the port's loss convention: each rank back-propagating its share
gives every rank its rows of the single-process gradient (within a
relative 1e-6 and 1e-6: fp32 sums of a few terms in another order), and back-propagating the reduced loss
instead (the control) gives 4× the gradient. The top-k merge orders ties
by the lower id, as `lax.top_k` does; on a 1 × 4 mesh of the same ranks,
whose blocks hold −0.0 and +0.0 on different ranks (and pad with −inf at
id m, as `dist_train.sharded_topk` pads), it ranks −0.0 below +0.0 and
returns `lax.top_k`'s ids and values of the whole row bit for bit."""

import pathlib

import numpy as np
import pytest
import torch

from gsrs_tpu_torch.ops.topk import topk_scores
from gsrs_tpu_torch.parallel import collectives as C
from gsrs_tpu_torch.parallel.launch import build_kernels_for, spawn
from gsrs_tpu_torch.parallel.mesh import (
    Mesh, choose_backend, distributed_init, make_mesh, single_device_mesh,
)

GRAD_RTOL = GRAD_ATOL = 1e-6
N_ROWS, DIM, BATCH = 8, 3, 8
SIGNED_M, SIGNED_KS = 64, (20, 21, 64)  # 4 blocks of 16: k = 64 reaches every block's pads


def signed_zero_rows() -> np.ndarray:
    """(3, 64): −1.0 with 19 ones (and two −1e9 masked entries) spread
    over the four blocks; row 0 has −0.0 at id 5 (block 0) and +0.0 at id
    40 (block 2), row 1 the two swapped; row 2 is seeded normals rounded
    to integers, many of them ±0."""
    rng = np.random.default_rng(11)
    x = np.full((3, SIGNED_M), -1.0, np.float32)
    for r, (neg, pos) in enumerate([(5, 40), (40, 5)]):
        cols = rng.permutation(np.setdiff1d(np.arange(SIGNED_M), [neg, pos]))
        x[r, cols[:19]], x[r, cols[19:21]] = 1.0, -1e9
        x[r, neg], x[r, pos] = -0.0, 0.0
    x[2] = np.round(rng.standard_normal(SIGNED_M)).astype(np.float32)
    return x


def problem():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(N_ROWS, DIM)).astype(np.float32)
    w = rng.normal(size=DIM).astype(np.float32)
    mix = rng.normal(size=(4, DIM, DIM)).astype(np.float32)  # rank r's part of the product
    idx = rng.integers(0, N_ROWS, BATCH)
    return table, w, mix, idx


def loss_of(table, w, mix_sum, idx):
    z = table @ mix_sum
    return ((z[idx] @ w) ** 2).mean() + 0.1 * (table ** 2).sum()


def _collectives_rank(device):
    table, w, mix, idx = problem()
    mesh = make_mesh(data_axis=2, model_axis=2, device=device)
    rows = slice(mesh.model_index * 4, mesh.model_index * 4 + 4)
    part = slice(mesh.data_index * 4, mesh.data_index * 4 + 4)
    out = {}
    for control in (False, True):
        local = torch.nn.Parameter(torch.from_numpy(table[rows].copy()))
        wp = torch.nn.Parameter(torch.from_numpy(w.copy()))
        full = C.all_gather_rows(local, mesh)
        (z,) = C.psum(mesh, full @ torch.from_numpy(mix[mesh.rank]))
        # the batch-independent term is replicated: each rank holds 1/size of it
        loss = ((z[torch.from_numpy(idx[part])] @ wp) ** 2).mean() + 0.1 * (full ** 2).sum()
        share = C.local_share(loss, mesh)
        if control:  # the reduced loss, back-propagated on every rank
            (share,) = C.psum(mesh, share)
        share.backward()
        C.sum_replicated_grads([wp], mesh)
        out[control] = (local.grad.clone(), wp.grad.clone(), float(C.all_reduce_(
            share.detach().clone(), mesh)) if not control else float(share.detach()))
    vals = torch.tensor([[5.0, 3.0, 3.0], [3.0, 1.0, 0.0]]) + mesh.model_index * 0.0
    ids = torch.tensor([[0, 2, 1], [4, 3, 5]]) + 6 * mesh.model_index
    out["merge"] = C.merge_topk(vals, ids, 4, mesh)
    out["bcast"] = C.broadcast_object({"rank": mesh.rank} if mesh.is_primary else None, mesh)
    out["gathered"] = C.all_gather(torch.tensor([mesh.rank]), mesh, "data")
    line = make_mesh(data_axis=1, model_axis=4, device=device)
    c = SIGNED_M // 4
    lo = line.model_index * c
    block = torch.from_numpy(signed_zero_rows()[:, lo:lo + c].copy())
    out["merge_signed"] = {}
    for k in SIGNED_KS:
        vals, idx = topk_scores(block, min(k, c), "exact")
        pad = (block.shape[0], k - vals.shape[1])
        vals = torch.cat([vals, vals.new_full(pad, float("-inf"))], dim=1)
        ids = torch.cat([idx + lo, idx.new_full(pad, SIGNED_M)], dim=1)
        out["merge_signed"][k] = C.merge_topk(vals, ids, k, line)
    return out


@pytest.fixture(scope="module")
def ranks():
    return spawn(_collectives_rank, 4, device_type="cpu", timeout_s=120)


def test_each_rank_gets_its_rows_of_the_single_process_gradient(ranks):
    table, w, mix, idx = problem()
    t = torch.from_numpy(table).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    ref = loss_of(t, wt, torch.from_numpy(mix.sum(0)), torch.from_numpy(idx))
    ref.backward()
    for r, out in enumerate(ranks):
        g_rows, g_w, loss = out[False]
        rows = slice((r % 2) * 4, (r % 2) * 4 + 4)
        np.testing.assert_allclose(g_rows.numpy(), t.grad[rows].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
        np.testing.assert_allclose(g_w.numpy(), wt.grad.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)
        assert abs(loss - ref.item()) <= 1e-5 * abs(ref.item())


def test_back_propagating_the_reduced_loss_counts_the_gradient_n_times(ranks):
    for out in ranks:
        (g_rows, g_w, _), (c_rows, c_w, _) = out[False], out[True]
        np.testing.assert_allclose(c_rows.numpy(), 4 * g_rows.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(c_w.numpy(), 4 * g_w.numpy(), rtol=1e-5, atol=1e-6)
        assert not np.allclose(c_w.numpy(), g_w.numpy(), rtol=0.5)


def test_merge_orders_ties_by_the_lower_id_and_broadcast_reaches_every_rank(ranks):
    for r, out in enumerate(ranks):
        vals, ids = out["merge"]
        # model shard 0 holds ids 0..5, shard 1 ids 6..11, with the same values
        np.testing.assert_array_equal(vals.numpy(), [[5, 5, 3, 3], [3, 3, 1, 1]])
        np.testing.assert_array_equal(ids.numpy(), [[0, 6, 1, 2], [4, 10, 3, 9]])
        assert out["bcast"] == {"rank": 0}
        np.testing.assert_array_equal(out["gathered"].numpy(), [r % 2, r % 2 + 2])


def test_merge_ranks_signed_zeros_on_four_ranks_as_lax_top_k(ranks):
    jax = pytest.importorskip("jax", reason="the JAX package is the reference")
    x = signed_zero_rows()
    assert ((x == 0) & np.signbit(x)).any(axis=1).all()
    for k in SIGNED_KS:
        wv, wi = (np.asarray(a) for a in jax.lax.top_k(x, k))
        for out in ranks:
            vals, ids = out["merge_signed"][k]
            np.testing.assert_array_equal(ids.numpy(), wi)
            np.testing.assert_array_equal(vals.numpy().view(np.int32), wv.view(np.int32))


def test_mesh_is_row_major_and_the_backend_is_asked_for():
    ranks = [Mesh(2, 3, r, torch.device("cpu")) for r in range(6)]
    assert [(m.data_index, m.model_index) for m in ranks] == [
        (0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    assert ranks[0].is_primary and not ranks[1].is_primary and ranks[4].size == 6
    assert choose_backend(None, "cpu", 4) == "gloo"
    assert choose_backend("gloo", "cuda", 64) == "gloo"
    with pytest.raises(ValueError, match="NCCL needs CUDA"):
        choose_backend("nccl", "cpu", 2)
    with pytest.raises(ValueError, match="gloo by name"):
        choose_backend(None, "cuda", torch.cuda.device_count() + 1)
    one = single_device_mesh("cpu")
    assert (one.size, one.world, one.rank) == (1, None, 0)
    x = torch.ones(3)
    assert C.all_reduce_(x, one) is x and C.psum(one, x)[0].equal(x)
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(data_axis=2, model_axis=2, device="cpu")


def test_every_kernel_is_built_before_the_ranks_start_on_the_card(monkeypatch):
    """`build_kernels_for` asks for every ``csrc/*.cu`` source on CUDA, so
    no rank compiles a kernel itself at its first call; on the CPU it asks
    for none."""
    from gsrs_tpu_torch import kernels

    asked = []
    monkeypatch.setattr(kernels, "build_kernels", lambda names: asked.append(sorted(names)))
    build_kernels_for("cpu")
    assert asked == []
    build_kernels_for("cuda")
    assert asked == [sorted(p.stem for p in pathlib.Path(kernels.CSRC_DIR).glob("*.cu"))]


def test_distributed_init_rejects_partial_explicit_config(monkeypatch):
    for var in ("GSRS_PROCESS_ID", "JAX_PROCESS_ID", "JAX_NUM_PROCESSES", "RANK",
                "WORLD_SIZE", "GSRS_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    assert distributed_init(device_type="cpu") is False  # nothing to join
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("GSRS_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="only one of"):
        distributed_init(device_type="cpu")


def test_shardings_say_which_rows_each_rank_holds():
    """The layouts' row ranges on a 2 × 3 mesh (no process group needed):
    tables split over ``model``, batches over ``data``, replicated
    parameters whole, dense hub blocks' columns over the whole mesh; an
    uneven table or batch is refused, naming what to do."""
    from gsrs_tpu_torch.parallel.seq_sharding import SeqShardings, slice_rows
    from gsrs_tpu_torch.parallel.sharding import GraphShardings, catalog_range, rows_of

    params = {"user_emb": torch.arange(12.0).view(6, 2), "item_emb": torch.arange(18.0).view(9, 2),
              "pop_fc1.weight": torch.ones(3, 1)}
    for rank in range(6):
        mesh = Mesh(2, 3, rank, torch.device("cpu"))
        sh = GraphShardings(mesh)
        assert sh.params_spec(params) == {"user_emb": "rows", "item_emb": "rows",
                                          "pop_fc1.weight": "replicated"}
        assert sh.opt_state_spec(None, params) == sh.params_spec(params)
        placed = sh.place_params(params)
        m = rank % 3
        assert torch.equal(placed["user_emb"], params["user_emb"][2 * m:2 * m + 2])
        assert torch.equal(placed["item_emb"], params["item_emb"][3 * m:3 * m + 3])
        assert placed["pop_fc1.weight"] is params["pop_fc1.weight"]
        assert sh.batch_spec(8) == slice(4 * (rank // 3), 4 * (rank // 3) + 4)
        assert sh.place_graph(params) is params  # the BipartiteGraph stays whole
        assert catalog_range(10, mesh) == [(0, 4), (4, 8), (8, 10)][m]
        seq = SeqShardings(mesh)
        assert seq.params_spec(params)["item_emb"] == "rows"
        assert seq.params_spec(params)["user_emb"] == "replicated"
        assert seq.padded_rows(51) == 51 and seq.padded_rows(52) == 54
    with pytest.raises(ValueError, match="pad_nodes_to_multiple"):
        rows_of(10, Mesh(1, 3, 0, torch.device("cpu")))
    with pytest.raises(ValueError, match="data axis"):
        GraphShardings(Mesh(2, 1, 0, torch.device("cpu"))).batch_spec(7)
    # a dense hub block's columns: C/size contiguous ones a rank, whole where C does not divide
    assert [GraphShardings(Mesh(2, 3, r, torch.device("cpu"))).dense_cols(12)
            for r in range(6)] == [(0, 2), (2, 4), (4, 6), (6, 8), (8, 10), (10, 12)]
    assert GraphShardings(Mesh(2, 3, 0, torch.device("cpu"))).dense_cols(10) is None
    draws = (torch.arange(8), [torch.ones(8, 2)], None)
    cut = slice_rows(draws, slice(2, 4))
    assert torch.equal(cut[0], torch.tensor([2, 3])) and cut[1][0].shape == (2, 2)
