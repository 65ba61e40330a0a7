"""Which slice of the sequential family's state each rank of the mesh
holds (port of `gsrs_tpu.parallel.seq_sharding`).

- ``item_emb``, the only catalog-scale tensor: padded with zero rows to
  the model axis's multiple and row-sharded over ``model``; the forward
  gathers it (`call_gathered`), its gradient is reduce-scattered back.
  Phantom rows are never gathered by an id (ids stop at the MASK row)
  and the catalog scored is the real rows;
- the encoder weights (attention, FFN, GRU, LayerNorm, positions):
  replicated, their gradients summed over the mesh;
- sequence batches: sharded over ``data``, every rank slicing the same
  global batch and its draws;
- the optimizer state follows its parameter.

Checkpoints hold the canonical, unpadded table (`canonical_state`), so
they move between meshes and one card; `local_state` pads and shards
them again.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch import nn

from gsrs_tpu_torch.parallel.collectives import all_gather_rows
from gsrs_tpu_torch.parallel.mesh import Mesh
from gsrs_tpu_torch.parallel.sharding import call_gathered, map_state, rows_of, take_rows

SEQ_TABLES = ("item_emb",)


def slice_rows(tree: Any, part: slice) -> Any:
    """``tree`` (tensors in tuples, named tuples, lists; None) with every
    tensor cut to rows ``part`` of its first dimension."""
    if isinstance(tree, torch.Tensor):
        return tree[part]
    if isinstance(tree, tuple):
        items = [slice_rows(v, part) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if isinstance(tree, list):
        return [slice_rows(v, part) for v in tree]
    return tree


@dataclasses.dataclass(frozen=True)
class SeqShardings:
    mesh: Mesh

    def params_spec(self, params: Dict[str, Any]) -> Dict[str, str]:
        """Each parameter's layout: "rows" (over ``model``) or "replicated"."""
        return {k: "rows" if k in SEQ_TABLES else "replicated" for k in params}

    def opt_state_spec(self, opt_state: Any, params: Dict[str, Any]) -> Dict[str, str]:
        return self.params_spec(params)

    def batch_spec(self, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch`` sequences."""
        D = self.mesh.data_size
        if batch % D:
            raise ValueError(f"a batch of {batch} does not split over the data axis ({D})")
        b = batch // D
        return slice(self.mesh.data_index * b, (self.mesh.data_index + 1) * b)

    def padded_rows(self, rows: int) -> int:
        return -(-rows // self.mesh.model_size) * self.mesh.model_size

    def place_model(self, model) -> None:
        """The model's item table (whole, canonical) → this rank's rows of
        the table padded to the model axis's multiple, in place."""
        full = model.item_emb.detach()
        rows = self.padded_rows(full.shape[0])
        padded = torch.cat([full, full.new_zeros(rows - full.shape[0], full.shape[1])])
        lo, hi = rows_of(rows, self.mesh)
        model.item_emb = nn.Parameter(padded[lo:hi].clone())

    def init_params(self, model, generator: torch.Generator, canonical_rows: int) -> None:
        """Draw every parameter as one card draws them from ``generator``,
        then keep this rank's rows of the padded item table."""
        d = model.item_emb.shape[1]
        model.item_emb = nn.Parameter(torch.empty(canonical_rows, d, device=self.mesh.device))
        model.init_params(generator)
        self.place_model(model)

    def call(self, model, method: str, *args, **kwargs):
        """``model.<method>`` on the whole item table (`call_gathered`)."""
        return call_gathered(model, self.mesh, SEQ_TABLES, method, *args, **kwargs)

    def gathered(self, model) -> Dict[str, torch.Tensor]:
        """{"item_emb": the whole padded table} (no gradient)."""
        with torch.no_grad():
            return {"item_emb": all_gather_rows(model.item_emb.detach(), self.mesh)}

    def canonical_state(self, params, opt, canonical_rows: int):
        """(params, optimizer state) with the item table and its moments
        gathered and cut to the canonical rows (a collective)."""
        def gather(name, t, is_moment):
            with torch.no_grad():
                return all_gather_rows(t.detach(), self.mesh)[:canonical_rows]

        return map_state(params, opt, SEQ_TABLES, gather)

    def local_state(self, params, opt, canonical_rows: int):
        """A canonical checkpoint → this rank's rows of the padded table
        (zero phantom rows, as `place_model` pads)."""
        rows = self.padded_rows(canonical_rows)

        def take(name, t, is_moment):
            return take_rows(t, rows, self.mesh)

        return map_state(params, opt, SEQ_TABLES, take)
