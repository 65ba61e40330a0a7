"""The explicit-collective training step (port of
`gsrs_tpu.parallel.shard_map_train`).

JAX's shard_map step writes out the communication that its GSPMD step
leaves to the compiler: ``all_gather`` of the row-sharded tables over
``model``, each rank's ELL partial of every layer, a ``psum`` over the
whole mesh to complete it, the local-batch BPR and the global mean with
the model-axis copies divided out. A torch rank always writes its
collectives out, so this step is `gsrs_tpu_torch.parallel.dist_train`'s
`mesh_step`, on the layouts the JAX step takes: ELL, segment (the
port's segment layout is its ELL layout) and tiled. JAX's step runs
``spmm_mode="tiled"`` through its edge (segment) path; this one runs the
tiled layer sharded as `GraphShardings.tiled_spec` shards it, whose sums
are the same. Hybrid raises, as in JAX. Dropout draws the canonical
edge mask (the tiled layout: the hash key) from the step's generator,
seeded alike on every rank, so every rank drops the same edges; i2i
smoothing runs on the assembled item table with no collective.
"""

from __future__ import annotations

from typing import Callable

from gsrs_tpu_torch.parallel.dist_train import _step_fn, check_layout
from gsrs_tpu_torch.parallel.mesh import Mesh


def make_shard_map_train_step(model, optimizer, mesh: Mesh, decay: float) -> Callable:
    """→ compile_for(params, opt_state) → step(params, opt_state, users,
    pos, neg, generator=None) → (params, opt_state, global loss), as
    `dist_train.make_train_step`. ``spmm_mode`` hybrid raises, as in JAX."""
    if model.cfg.spmm_mode == "hybrid":
        raise ValueError(
            "spmm_mode='hybrid' is not wired into the explicit shard_map step; use "
            "dist_train.make_train_step (or the Trainer's mesh path), which shards the hybrid "
            "dense blocks and residual ELL")
    check_layout(model, mesh)
    return _step_fn(model, optimizer, mesh, decay)
