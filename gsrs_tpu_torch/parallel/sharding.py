"""Which slice of the graph family's state each rank of the mesh holds
(port of `gsrs_tpu.parallel.sharding`). JAX annotates NamedShardings and
lets GSPMD move the data; here a layout says which rows a rank keeps.

- embedding tables (``user_emb``, ``item_emb``): row-sharded over
  ``model``; the forward gathers them (`all_gather_rows`), whose backward
  reduce-scatters the gradient back to the owning shard;
- the other parameters (the pop gate's, NGCF's layer weights): replicated;
- the optimizer state follows its parameter;
- the ELL layout: every bucket's rows sharded over the whole mesh
  (`place_ell`: padded, then each rank keeps 1/size of the edge slots);
  a layer on the shard gives partial rows that a psum completes. The
  BipartiteGraph stays whole on the host: the port reads its edges
  through the ELL, and the edge-dropout mask is drawn whole on every rank
  from the same generator;
- the tiled and hybrid layouts (`tiled_spec`, `hybrid_spec`): each
  direction's residual ELL sharded as the ELL layout is, and its dense
  hub block column-sharded over the whole mesh when its C columns divide
  by the mesh size: the rank keeps its C/size contiguous columns (per
  group, for tiled) and the matching hub ids, so its product is a
  partial sum over its columns that the layer's psum completes, as GSPMD
  splits the contraction in JAX. A block whose C does not divide stays
  whole on every rank, and rank 0 alone adds its product (forward and
  transpose), so the psum counts it once. The gather maps and canonical
  edge lists (``order_dst``, ``row_nat``, ``res_dst``, ``res_src``) stay
  whole; the hash dropout masks are computed on the rank's columns and
  hub ids, so they drop the edges one card drops;
- BPR batches: sharded over ``data`` (`batch_spec`), every rank slicing
  the same global batch.

`place_model` applies all of it to a built model in place: its table
parameters become the rank's rows, and its propagation layer runs on the
rank's part of its layout, completed by a psum after every layer.
`call_gathered` runs a model method on the gathered tables.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from gsrs_tpu_torch.ops.ell import EllGraph, pad_ell_graph, shard_ell_graph
from gsrs_tpu_torch.ops.hybrid import HybridGraph
from gsrs_tpu_torch.ops.tiled import TiledGraph, occ_side
from gsrs_tpu_torch.parallel.collectives import all_gather_rows, psum
from gsrs_tpu_torch.parallel.mesh import Mesh

GRAPH_TABLES = ("user_emb", "item_emb")


class _Method(nn.Module):
    """``model.<name>(...)`` as a module's forward, for `functional_call`."""

    def __init__(self, model: nn.Module, name: str):
        super().__init__()
        self.model = model
        self.name = name

    def forward(self, *args, **kwargs):
        return getattr(self.model, self.name)(*args, **kwargs)


def call_with(model: nn.Module, tables: Dict[str, torch.Tensor], method: str, *args,
              **kwargs):
    """``model.<method>(*args)`` with the parameters named in ``tables``
    replaced by the given tensors for the call."""
    full = {f"model.{name}": t for name, t in tables.items()}
    return torch.func.functional_call(_Method(model, method), full, args, kwargs)


def call_gathered(model: nn.Module, mesh: Mesh, tables: Sequence[str], method: str,
                  *args, **kwargs):
    """``model.<method>(*args)`` with each of ``tables`` (this rank's row
    shard) replaced by the whole table gathered over the model axis; the
    gradient flows back to the shards."""
    full = {name: all_gather_rows(getattr(model, name), mesh) for name in tables}
    return call_with(model, full, method, *args, **kwargs)


def rows_of(n: int, mesh: Mesh) -> Tuple[int, int]:
    """[lo, hi): this rank's rows of an n-row table sharded over ``model``."""
    M = mesh.model_size
    if n % M:
        raise ValueError(f"a table of {n} rows does not split over the model axis ({M}): pad "
                         "the data with gsrs_tpu_torch.data.dataset.pad_nodes_to_multiple")
    r = n // M
    return mesh.model_index * r, (mesh.model_index + 1) * r


def catalog_range(m: int, mesh: Mesh) -> Tuple[int, int]:
    """[lo, hi): this rank's items of an m-item catalog scored shard by
    shard over ``model`` (⌈m/M⌉ items a shard, the last one shorter)."""
    c = -(-m // mesh.model_size)
    lo = min(m, mesh.model_index * c)
    return lo, min(m, lo + c)


def take_rows(canonical: torch.Tensor, n_rows: int, mesh: Mesh,
              live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """This rank's rows of an ``n_rows`` table from its canonical form (the
    real rows only, as checkpoints hold it). Rows past the canonical ones
    (phantom nodes) keep ``live``'s values, or 0 without it."""
    if canonical.shape[0] > n_rows:
        raise ValueError(f"a table of {canonical.shape[0]} rows does not fit the model's "
                         f"{n_rows}")
    lo, hi = rows_of(n_rows, mesh)
    if live is not None:
        out = live.detach().clone()
    else:
        out = canonical.new_zeros(hi - lo, *canonical.shape[1:])
    top = min(hi, canonical.shape[0])
    if top > lo:
        out[: top - lo] = canonical[lo:top].to(out.device, out.dtype)
    return out


def map_state(params: Dict[str, Any], opt: Dict[str, Any], tables: Sequence[str],
               fn: Callable) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``fn(name, tensor, is_moment)`` applied to each table parameter and
    to its optimizer moments, in `train.optim.optimizer_state_dict`'s
    form; everything else as it is."""
    names = list(params)
    params = {k: fn(k, v, False) if k in tables else v for k, v in params.items()}
    if opt["kind"] == "adam":
        state = {i: {key: fn(names[i], v, True)
                     if key in ("exp_avg", "exp_avg_sq") and names[i] in tables else v
                     for key, v in s.items()}
                 for i, s in opt["torch"]["state"].items()}
        opt = {**opt, "torch": {**opt["torch"], "state": state}}
    else:
        opt = {**opt, **{key: [fn(n, t, True) if n in tables else t
                               for n, t in zip(opt["names"], opt[key])] for key in ("mu", "nu")}}
    return params, opt


@dataclasses.dataclass(frozen=True)
class GraphShardings:
    mesh: Mesh

    # ------------------------------------------------------------- params
    def params_spec(self, params: Dict[str, Any]) -> Dict[str, str]:
        """Each parameter's layout: "rows" (over ``model``) or "replicated"."""
        return {k: "rows" if k in GRAPH_TABLES else "replicated" for k in params}

    def opt_state_spec(self, opt_state: Any, params: Dict[str, Any]) -> Dict[str, str]:
        """The optimizer state's moments follow their parameter's layout;
        the step count is replicated."""
        return self.params_spec(params)

    def place_params(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Whole parameters → this rank's part (a copy of its table rows)."""
        out = {}
        for k, v in params.items():
            if k in GRAPH_TABLES:
                lo, hi = rows_of(v.shape[0], self.mesh)
                v = v.detach()[lo:hi].clone()
            out[k] = v
        return out

    # -------------------------------------------------------------- graph
    def place_graph(self, graph):
        """The BipartiteGraph as every rank holds it: whole, on the host
        (its edges reach the device through `place_ell`'s shards)."""
        return graph

    def place_ell(self, ell):
        """This rank's part of a layout (`EllGraph`, `TiledGraph` or
        `HybridGraph`) on its device: an ELL's buckets padded to a multiple
        of the mesh size and sharded over the whole mesh; the tiled and
        hybrid layouts as `tiled_spec` and `hybrid_spec` give them."""
        if isinstance(ell, TiledGraph):
            return self.tiled_spec(ell).to(self.mesh.device)
        if isinstance(ell, HybridGraph):
            return self.hybrid_spec(ell).to(self.mesh.device)
        if not isinstance(ell, EllGraph):
            raise TypeError(f"place_ell takes an EllGraph, TiledGraph or HybridGraph, got "
                            f"{type(ell).__name__}")
        return self._local_ell(ell).to(self.mesh.device)

    def _local_ell(self, ell: EllGraph) -> EllGraph:
        """This rank's shard of an ELL (CPU tensors)."""
        n = self.mesh.size
        return shard_ell_graph(pad_ell_graph(ell.to("cpu"), n), n).local(self.mesh.rank)

    def dense_cols(self, cols: int) -> Optional[Tuple[int, int]]:
        """[lo, hi): this rank's columns of a dense block of ``cols``
        columns, or None where they do not divide by the mesh size (the
        block stays whole)."""
        n = self.mesh.size
        if cols == 0 or cols % n:
            return None
        c = cols // n
        return self.mesh.rank * c, (self.mesh.rank + 1) * c

    def tiled_spec(self, tg: TiledGraph) -> TiledGraph:
        """This rank's part of a TiledGraph, on the layout's device but for
        the residual shards and ``occ`` (CPU): per direction the residual
        ELL sharded as `place_ell` shards an ELL, and the (G·rows_g, C)
        hub block's columns [lo, hi) of every group, with the (G, C/size)
        slices of ``top_src`` and ``slot_w`` and an ``occ`` side built over
        them, so that its backward returns the rank's partial of the hub
        rows' cotangents; or, where C does not divide, the whole block,
        added by rank 0 alone."""
        def part(d):
            d = dataclasses.replace(d, residual=self._local_ell(d.residual))
            cols = self.dense_cols(d.cols)
            if cols is None:
                return dataclasses.replace(d, adds_dense=self.mesh.rank == 0)
            lo, hi = cols
            top, slot_w = d.top_src[:, lo:hi].cpu(), d.slot_w[:, lo:hi].cpu()
            return dataclasses.replace(
                d, dense=d.dense[:, lo:hi].contiguous(), top_src=top.contiguous(),
                slot_w=slot_w.contiguous(), cols=hi - lo,
                occ=occ_side(top.numpy(), slot_w.numpy(), d.occ.n_rows))

        return dataclasses.replace(tg, user_from_item=part(tg.user_from_item),
                                   item_from_user=part(tg.item_from_user))

    def hybrid_spec(self, hg: HybridGraph) -> HybridGraph:
        """This rank's part of a HybridGraph: per direction the residual
        ELL sharded as `place_ell` shards an ELL (CPU), and the (n_dst, C)
        dense block's columns [lo, hi) with their hub ids (distinct: the
        backward's `index_add_` still adds once into each row) and their
        nonzero cells; or, where C does not divide, the whole block, added
        by rank 0 alone."""
        def part(d):
            d = dataclasses.replace(d, residual=self._local_ell(d.residual))
            cols = self.dense_cols(d.top_src.numel())
            if cols is None:
                return dataclasses.replace(d, adds_dense=self.mesh.rank == 0)
            lo, hi = cols
            cell = (d.dense_col >= lo) & (d.dense_col < hi)
            return dataclasses.replace(
                d, dense=d.dense[:, lo:hi].contiguous(), top_src=d.top_src[lo:hi].contiguous(),
                dense_dst=d.dense_dst[cell], dense_col=d.dense_col[cell] - lo)

        return dataclasses.replace(hg, user_from_item=part(hg.user_from_item),
                                   item_from_user=part(hg.item_from_user))

    # -------------------------------------------------------------- batch
    def batch_spec(self, batch: int) -> slice:
        """This rank's part of a global batch of ``batch`` rows (over ``data``)."""
        D = self.mesh.data_size
        if batch % D:
            raise ValueError(f"a batch of {batch} does not split over the data axis ({D})")
        b = batch // D
        return slice(self.mesh.data_index * b, (self.mesh.data_index + 1) * b)

    # -------------------------------------------------------------- model
    def place_model(self, model) -> None:
        """Shard ``model`` in place: its layout (ELL, tiled or hybrid)
        becomes this rank's part (`place_ell`), completed by a psum after
        every layer, and its tables this rank's rows (of the parameters it
        holds now). The i2i graph stays whole (replicated)."""
        if isinstance(model.ell, (EllGraph, TiledGraph, HybridGraph)):
            model.ell = self.place_ell(model.ell)
            model.layer_sum = functools.partial(psum, self.mesh)
        self._keep_rows(model)

    def _keep_rows(self, model) -> None:
        for name in GRAPH_TABLES:
            full = getattr(model, name)
            lo, hi = rows_of(full.shape[0], self.mesh)
            setattr(model, name, nn.Parameter(full.detach()[lo:hi].clone()))

    def init_params(self, model, generator: torch.Generator) -> None:
        """Draw the model's parameters as one card draws them, from
        ``generator``, and keep this rank's table rows."""
        d = model.cfg.embedding_dim
        dev = self.mesh.device
        for name, n in zip(GRAPH_TABLES, (model.n_users, model.m_items)):
            setattr(model, name, nn.Parameter(torch.empty(n, d, device=dev)))
        model.init_params(generator)
        self._keep_rows(model)

    def call(self, model, method: str, *args, **kwargs):
        """``model.<method>`` on the whole tables (`call_gathered`)."""
        return call_gathered(model, self.mesh, GRAPH_TABLES, method, *args, **kwargs)

    # --------------------------------------------------------- checkpoint
    def canonical_state(self, params, opt, real_rows: Dict[str, int]):
        """(params, optimizer state) in the single-card checkpoint form:
        every table and its moments gathered and cut to ``real_rows``
        (phantom rows dropped). A collective: every rank calls it."""
        def gather(name, t, is_moment):
            with torch.no_grad():
                return all_gather_rows(t.detach(), self.mesh)[: real_rows[name]]

        return map_state(params, opt, GRAPH_TABLES, gather)

    def local_state(self, params, opt, live: Dict[str, torch.Tensor],
                    full_rows: Dict[str, int]):
        """A canonical checkpoint's (params, optimizer state) → this rank's
        part: table rows of the run's padded tables, phantom rows keeping
        ``live``'s values (0 in the moments)."""
        def take(name, t, is_moment):
            return take_rows(t, full_rows[name], self.mesh, None if is_moment else live[name])

        return map_state(params, opt, GRAPH_TABLES, take)
