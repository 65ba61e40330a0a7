"""Training and eval steps over a (data, model) mesh (port of
`gsrs_tpu.parallel.dist_train`).

JAX's GSPMD step and its shard_map step differ in who writes the
collectives; in torch both are the same explicit math, `mesh_step`, the
one core of `make_train_step` and
`gsrs_tpu_torch.parallel.shard_map_train.make_shard_map_train_step`:

1. every rank takes the same global batch and keeps its ``data`` slice
   (the whole batch for a model whose loss couples its rows);
2. the row-sharded tables are gathered over ``model`` (`call_gathered`);
3. each layer runs on the rank's part of the layout and a psum over the
   mesh completes it (`GraphShardings.place_model`): the gather-reduce
   kernel on its ELL shard, or on its tiled or hybrid residual shard
   beside the product of its columns of the dense hub blocks (the tiled
   backward's ``occ`` side built over those columns); a bf16 layer's
   partials are summed in fp32 and rounded once;
4. the local-batch loss, as this rank's share of the global loss
   (`collectives.local_share`), is back-propagated: the psums' and the
   gather's backwards sum the gradients, the replicated parameters'
   gradients are summed over the mesh;
5. the optimizer (the fused Adam kernel under ``fused_adam="pallas"``)
   updates the rank's rows and the replicated parameters.

`make_eval_scores_fn` is the sharded masked top-k: each rank scores its
catalog shard for its data slice of users with the masked-scoring kernel,
takes a local top-k, and the model axis merges the (B, k) values and
global ids with JAX's tie order (`sharded_topk`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from gsrs_tpu_torch.ops.ell import EllGraph
from gsrs_tpu_torch.ops.hybrid import HybridGraph
from gsrs_tpu_torch.ops.scoring import masked_scores
from gsrs_tpu_torch.ops.tiled import TiledGraph
from gsrs_tpu_torch.ops.topk import topk_scores
from gsrs_tpu_torch.parallel.collectives import (
    all_reduce_, local_share, merge_topk, sum_replicated_grads,
)
from gsrs_tpu_torch.parallel.mesh import Mesh
from gsrs_tpu_torch.parallel.sharding import GRAPH_TABLES, GraphShardings


def mesh_step(model, optimizer, mesh: Mesh, params, opt_state, users, pos, neg, decay: float,
              generator: Optional[torch.Generator] = None):
    """One optimizer step of the global (B,) batch on this rank →
    (opt_state, this rank's share of ``loss + decay · reg``); the shares
    sum to the global loss over the mesh. ``params``: the model's live
    parameters (table rows and replicated ones), updated in place."""
    sh = GraphShardings(mesh)
    if model.batch_separable:
        part = sh.batch_spec(users.shape[0])
        users, pos, neg = users[part], pos[part], neg[part]
    loss, aux = sh.call(model, "bpr_loss", users, pos, neg, generator)
    share = local_share(loss + decay * aux["reg"], mesh)
    share.backward()
    sum_replicated_grads([p for k, p in params.items() if k not in GRAPH_TABLES], mesh)
    return optimizer.step(params, opt_state), share.detach()


def check_layout(model, mesh: Mesh) -> None:
    """The layouts a mesh step runs: the ELL (and segment), tiled and
    hybrid layouts sharded by `GraphShardings.place_model`, or none (MF,
    UltraGCN replicate whatever the slot holds)."""
    if (isinstance(model.ell, (EllGraph, TiledGraph, HybridGraph)) and mesh.size > 1
            and model.layer_sum is None):
        raise ValueError(f"the model's {type(model.ell).__name__} layout is not sharded: place "
                         "the model with GraphShardings(mesh).place_model(model) first")


def _step_fn(model, optimizer, mesh: Mesh, decay: float) -> Callable:
    uses_generator = bool(model.cfg.dropout) or getattr(model, "needs_step_key", False)

    def compile_for(params, opt_state):
        def step(params, opt_state, users, pos, neg, generator=None):
            if uses_generator and generator is None:
                raise ValueError("the model draws per-step randomness: pass a generator")
            opt_state, share = mesh_step(model, optimizer, mesh, params, opt_state, users, pos,
                                         neg, decay, generator if uses_generator else None)
            return params, opt_state, all_reduce_(share, mesh)

        return step

    return compile_for


def make_train_step(model, optimizer, mesh: Mesh, decay: float) -> Callable:
    """→ compile_for(params, opt_state) → step(params, opt_state, users,
    pos, neg, generator=None) → (params, opt_state, global loss).
    ``users``/``pos``/``neg``: the global batch, the same on every rank;
    ``generator`` (on the rank's device, seeded alike on every rank) draws
    the edge dropout and the models' per-step noise. Parameters are the
    model's, placed by `GraphShardings.place_model` and updated in place."""
    check_layout(model, mesh)
    return _step_fn(model, optimizer, mesh, decay)


# --------------------------------------------------------------- eval


def sharded_topk(
    u_emb: torch.Tensor,
    items: torch.Tensor,
    rows: torch.Tensor,
    k: int,
    mesh: Mesh,
    offset: int,
    m_total: int,
    method: str = "exact",
    recall_target: float = 0.95,
    rescale: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The masked top-k of (B, d) users over a catalog sharded over
    ``model``: this rank's (m_s, d) ``items`` start at global id
    ``offset``, ``rows`` are the users' (B, ⌈m_s/32⌉) bitset words over
    the shard's columns. The masked-scoring kernel scores the shard, a
    local top-k by ``method`` follows (``rescale`` first maps the raw
    scores, as the int8 serving path does), and `merge_topk` merges the
    model axis's candidates → (B, k) values and global ids, the same on
    every model rank. A shard with fewer than k items pads its candidates
    with −inf at id ``m_total``."""
    scores = masked_scores(u_emb, items, rows)
    if rescale is not None:
        scores = rescale(scores)
    kk = min(k, items.shape[0])
    vals, idx = topk_scores(scores, kk, method, recall_target)
    ids = idx + offset
    if kk < k:
        pad = (u_emb.shape[0], k - kk)
        vals = torch.cat([vals, vals.new_full(pad, float("-inf"))], dim=1)
        ids = torch.cat([ids, ids.new_full(pad, m_total)], dim=1)
    return merge_topk(vals, ids, k, mesh)


def make_eval_scores_fn(model, mesh: Mesh) -> Callable:
    """→ scores_topk(all_users, items, users, train_rows, k, method="exact",
    recall_target=0.95) → (B/D, k) values and global item ids of this
    rank's data slice of users. ``all_users``: every user's final
    embedding (the propagation leaves them whole on every rank);
    ``items``: the final item embeddings, whole, of which this rank scores
    its catalog shard (`catalog_range`); ``users``: the global (B,) batch;
    ``train_rows``: the batch's train bitset rows (B, W) over the whole
    catalog."""
    from gsrs_tpu_torch.ops.bitset import bitset_columns
    from gsrs_tpu_torch.parallel.sharding import catalog_range

    sh = GraphShardings(mesh)

    def scores_topk(all_users, items, users, train_rows, k: int, method: str = "exact",
                    recall_target: float = 0.95):
        part = sh.batch_spec(users.shape[0])
        lo, hi = catalog_range(items.shape[0], mesh)
        return sharded_topk(all_users[users[part]], items[lo:hi],
                            bitset_columns(train_rows[part], lo, hi), k, mesh, lo,
                            items.shape[0], method, recall_target)

    return scores_topk
