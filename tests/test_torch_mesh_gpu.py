"""The mesh on the card (marked ``gpu``; skipped without a CUDA card): two
gloo ranks on one card train a 1 × 2 mesh step for step with the single
card (losses within a relative 1e-5, parameters within 1e-5, the
summation order of the psums differing) and each rank launches the ELL
gather-reduce (K4), the fused Adam (K3) and the masked scoring (K1)
kernels; a one-rank NCCL group runs the same steps through the mesh's
collectives."""

import numpy as np
import pytest
import torch

from gsrs_tpu_torch.config import ModelConfig, TrainConfig
from gsrs_tpu_torch.data.adjacency import build_graph
from gsrs_tpu_torch.data.synthetic import clustered
from gsrs_tpu_torch.models.registry import build_model
from gsrs_tpu_torch.ops import ell_kernel, scoring
from gsrs_tpu_torch.ops.ell import ell_from_interactions
from gsrs_tpu_torch.ops.sampling import make_sampler_state, sample_triplets
from gsrs_tpu_torch.parallel.collectives import all_gather_rows
from gsrs_tpu_torch.parallel.dist_train import make_eval_scores_fn, make_train_step
from gsrs_tpu_torch.parallel.launch import build_kernels_for, spawn
from gsrs_tpu_torch.parallel.mesh import Mesh, make_mesh, single_device_mesh
from gsrs_tpu_torch.parallel.sharding import GraphShardings
from gsrs_tpu_torch.train import fused_adam
from gsrs_tpu_torch.train.optim import make_optimizer

LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5
DATA = dict(n_users=300, m_items=400, n_clusters=5, seed=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the mesh's ranks run the CUDA kernels, which have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    build_kernels_for("cuda")
    return torch.device("cuda:0")


def batches(device):
    data = clustered(**DATA)
    g = torch.Generator(device).manual_seed(3)
    state = make_sampler_state(data, device)
    return [tuple(t.cpu() for t in sample_triplets(g, state, 256)) for _ in range(3)]


def steps(mesh, batch_list):
    """3 fused-Adam (K3) mesh steps from seeded parameters → (losses, the
    whole tables, launches)."""
    data = clustered(**DATA)
    model = build_model(ModelConfig(num_layers=2, embedding_dim=16),
                        build_graph(data, edge_pad_multiple=256),
                        ell=ell_from_interactions(data), device=mesh.device)
    sh = GraphShardings(mesh)
    sh.place_model(model)
    sh.init_params(model, torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    optimizer, _ = make_optimizer(TrainConfig(lr=1e-2, fused_adam="pallas"), 1)
    opt_state = optimizer.init(params)
    step = make_train_step(model, optimizer, mesh, 1e-4)(params, opt_state)
    for c in (ell_kernel.LAUNCHES, scoring.LAUNCHES, fused_adam.LAUNCHES):
        c.update({k: 0 for k in c})
    losses = []
    for b in batch_list:
        params, opt_state, loss = step(params, opt_state, *(t.to(mesh.device) for t in b))
        losses.append(float(loss))
    with torch.no_grad():
        all_users, items, _ = sh.call(model, "final_embeddings")
        users = torch.arange(64, device=mesh.device)
        rows = torch.zeros(64, (data.m_items + 31) // 32, dtype=torch.int32, device=mesh.device)
        make_eval_scores_fn(model, mesh)(all_users, items, users, rows, 10)
        whole = {k: all_gather_rows(params[k].detach(), mesh).cpu()
                 for k in ("user_emb", "item_emb")}
    launches = dict(ell_kernel.LAUNCHES, **scoring.LAUNCHES, **fused_adam.LAUNCHES)
    return losses, whole, launches


def _gloo_rank(device, batch_list):
    return steps(make_mesh(data_axis=1, model_axis=2, device=device), batch_list)


def _nccl_rank(device, batch_list):
    import torch.distributed as dist

    world = dist.group.WORLD
    return steps(Mesh(1, 1, 0, device, dist.get_backend(), world, world, world), batch_list)


@pytest.mark.gpu
@pytest.mark.parametrize("backend,n_ranks", [("gloo", 2), ("nccl", 1)])
def test_mesh_steps_on_the_card_match_the_card(cuda, backend, n_ranks):
    batch_list = batches(cuda)
    losses, whole, _ = steps(single_device_mesh(cuda), batch_list)
    worker = _gloo_rank if backend == "gloo" else _nccl_rank
    for r, (got_losses, got, launches) in enumerate(
            spawn(worker, n_ranks, batch_list, device_type="cuda", backend=backend,
                  timeout_s=300)):
        np.testing.assert_allclose(got_losses, losses, rtol=LOSS_RTOL)
        for k, v in whole.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=PARAM_ATOL)
        for name in ("ell_gather_reduce", "masked_scores", "fused_adam"):
            assert launches[name] > 0, (r, name, launches)
