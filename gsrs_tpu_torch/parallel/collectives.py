"""The collectives of the mesh as autograd functions: what GSPMD and
`jax.lax` give the JAX package, written out over `torch.distributed`.

The loss convention, held by every mesh path of the port:

    Each rank back-propagates its own share of the global loss, never
    the reduced loss. Its share is its local batch's terms, each scaled
    by the slice's part of the term's global normaliser, divided by the
    model-axis copies of the slice (the ranks that share a data index
    hold the same batch slice). For a batch mean over equal slices that
    is the local loss over ``mesh.size`` (`local_share`). The shares sum
    to the global loss over the mesh.

Under it the backward of every collective below is the collective of
the gradients: `psum`'s is a psum; `all_gather_rows`'s is a sum of the
gathered table's cotangents over the whole mesh, reduce-scattered back
to the owning model shard and summed over the data axis; and the
gradients of replicated parameters are summed over the mesh
(`sum_replicated_grads`). Back-propagating the reduced loss instead would
count every gradient ``mesh.size`` times. A collective over an axis
without a process group (an axis of one rank, the 1 × 1 mesh) is the
identity.

`psum` sums bf16 (and fp16) tensors in fp32: it casts them, all-reduces
and rounds the sum once to their dtype, so a bf16 layer's partials are
rounded as one card rounds its layer's sum, once, whatever the backend
and the number of ranks.

`merge_topk` merges the catalog shards' top-k over the model axis in
`lax.top_k`'s order (−0.0 below +0.0, then the lower item id first),
which neither `torch.topk` nor a float sort gives.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import torch
import torch.distributed as dist

from gsrs_tpu_torch.ops.topk import stable_topk
from gsrs_tpu_torch.parallel.mesh import Mesh


def _axis(mesh: Mesh, axis: str):
    """(group, size) of ``axis``: "data", "model" or "mesh"; the group is
    None where no collective runs."""
    if axis == "data":
        return mesh.data_group, mesh.data_size
    if axis == "model":
        return mesh.model_group, mesh.model_size
    return mesh.world, mesh.size


def all_reduce_(x: torch.Tensor, mesh: Mesh, axis: str = "mesh") -> torch.Tensor:
    """In-place sum of ``x`` over ``axis`` → ``x``."""
    group, _ = _axis(mesh, axis)
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """The ``axis`` ranks' ``x`` stacked along dim 0, in rank order."""
    group, size = _axis(mesh, axis)
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_gather(x, mesh, "model")

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = g.contiguous()
        if mesh.model_group is not None:
            out = g.new_empty(g.shape[0] // mesh.model_size, *g.shape[1:])
            dist.reduce_scatter(out, list(g.chunk(mesh.model_size)), group=mesh.model_group)
            g = out
        return all_reduce_(g.clone(), mesh, "data"), None


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A row-sharded table, whole: the model axis's row shards stacked."""
    return _AllGatherRows.apply(x, mesh)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return _sum_flat(xs, mesh)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_sum_flat(gs, ctx.mesh))


def _sum_flat(xs, mesh: Mesh) -> Tuple[torch.Tensor, ...]:
    """Sum every tensor of ``xs`` over the mesh with one all-reduce of
    their concatenation (one dtype; a 16-bit float one summed in fp32 and
    rounded once)."""
    if mesh.world is None:
        return tuple(x.clone() for x in xs)
    flat = torch.cat([x.reshape(-1) for x in xs])
    wide = flat.float() if flat.dtype in (torch.bfloat16, torch.float16) else flat
    dist.all_reduce(wide, group=mesh.world)
    flat = wide.to(flat.dtype)
    return tuple(p.view_as(x) for p, x in zip(flat.split([x.numel() for x in xs]), xs))


def psum(mesh: Mesh, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each of ``xs`` summed over the whole mesh (one collective)."""
    return _Psum.apply(mesh, *xs)


def local_share(loss: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A rank's share of a global batch mean it computed over its equal
    slice (or over the whole batch, replicated): ``loss / mesh.size``."""
    return loss / mesh.size


def sum_replicated_grads(params: Iterable[torch.nn.Parameter], mesh: Mesh) -> None:
    """Sum the ``.grad`` of replicated parameters over the mesh, in one
    all-reduce per dtype. A parameter without a gradient has none on
    every rank (each runs the same graph) and is left so."""
    params = [p for p in params if p.grad is not None]
    if mesh.world is None or not params:
        return
    for dtype in {p.dtype for p in params}:
        group = [p for p in params if p.dtype == dtype]
        flat = torch.cat([p.grad.reshape(-1) for p in group])
        dist.all_reduce(flat, group=mesh.world)
        for p, g in zip(group, flat.split([p.numel() for p in group])):
            p.grad.copy_(g.view_as(p))


def merge_topk(vals: torch.Tensor, ids: torch.Tensor, k: int,
               mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``k`` of the model axis's (B, k') candidates (values,
    global ids) → (B, k) values and ids on every model rank in
    `lax.top_k`'s order: descending in XLA's total order (−0.0 below
    +0.0), equal values by the lower id: `stable_topk` of the candidates
    put in id order. A shard's −inf pads (at id m_total) rank below every
    score."""
    vals, ids = all_gather_cols(vals, mesh), all_gather_cols(ids, mesh)
    by_id = torch.argsort(ids, dim=1, stable=True)
    vals, order = stable_topk(vals.gather(1, by_id), k)
    return vals, ids.gather(1, by_id).gather(1, order)


def all_gather_cols(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The model axis's (B, c) blocks side by side: (B, M · c)."""
    if mesh.model_group is None:
        return x
    return torch.cat(list(all_gather(x, mesh, "model").chunk(mesh.model_size)), dim=1)


def broadcast_object(obj, mesh: Mesh):
    """Rank 0's ``obj`` on every rank (pickled; objects of this program)."""
    if mesh.world is None:
        return obj
    box: List = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.world,
                               device=mesh.device if mesh.backend == "nccl" else None)
    return box[0]


def barrier(mesh: Mesh) -> None:
    if mesh.world is not None:
        dist.barrier(group=mesh.world)
