"""Retrieval serving: precomputed embeddings + masked top-k on the card
(port of `gsrs_tpu.serve`).

- ``Retriever``: propagation has run once, before it is built; each
  request is a gather of user rows, one launch of the masked-scoring
  CUDA kernel (`gsrs_tpu_torch.ops.scoring`) and the exact top-k in
  ``lax.top_k``'s order (`gsrs_tpu_torch.ops.topk.exact_topk`).
- ``export_embeddings`` / ``load_retriever``: the npz artifact of the JAX
  package, same schema (``seen_bitset`` as uint32 words), so artifacts
  of the two packages interchange.

CLI:
  python -m gsrs_tpu_torch.serve export --checkpoint_dir checkpoints --dataset_dir data/gowalla --out emb.npz [--quantize int8]
  python -m gsrs_tpu_torch.serve query --artifact emb.npz --users 0 1 2 --k 20

``export`` restores the newest checkpoint of a training run (``last``,
then the legacy name) into the model that ``model_meta.json`` describes
(the flags describe it when that file is missing), propagates once and
writes the artifact. Both run on ``cuda:0`` unless ``--device`` says
otherwise.

Sharded serving: ``Retriever(mesh=...)`` keeps on each rank its rows of
the user table and its shard of the catalog, both padded to the model
axis's multiple, with the phantom columns set in every row of the seen
bitset (so a padding item never outranks a real one). Rank 0 takes a
request and broadcasts the user ids; each rank scores its catalog shard
with the masked-scoring kernel (int8 tables shard by shard, as on one
card) and the model axis merges the top-k with the JAX package's tie
order. There is no bit-plane layout on a mesh, as in the JAX package.
``query --model_axis M`` starts the M ranks itself; ``export --model_axis
M`` pads the dataset as a mesh run of M padded it and writes the
canonical, unpadded artifact.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gsrs_tpu_torch.device import DeviceLike, resolve_device
from gsrs_tpu_torch.ops.bitset import bitset_to_numpy, bitset_to_tensor, build_bitset
from gsrs_tpu_torch.ops.scoring import (
    bitplane_permutation,
    masked_scores,
    resolve_bitplane_scoring,
)
from gsrs_tpu_torch.ops.topk import NEG_INF, masked_topk, topk_scores

BITPLANE_BLOCK_M = 4096


def _table(x: Any, device: torch.device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    t = x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


@dataclasses.dataclass
class Retriever:
    """Serves top-k recommendations from precomputed final embeddings,
    on ``device`` (default ``cuda:0``).

    The public fields stay canonical (natural item order, real row
    counts) and become tensors on the device; ``seen_bitset`` becomes an
    int32 view of its uint32 words. Serving-side transformations (the
    bit-plane permutation, fp32 copies of int8 tables) live only in the
    private serve tables.

    int8 mode (``user_scale``/``item_scale`` set, as `load_retriever`
    does for a quantized artifact): the int8 tables are scored by the
    same kernel in fp32, which is exact (|Σ q_u·q_i| ≤ d·127² < 2^24 for
    d < 1040), and the rank-1 scale correction follows."""

    user_emb: Any  # (n, d) post-propagation user representations
    item_emb: Any  # (m, d) post-propagation (+fused) item table
    seen_bitset: Any  # (n, ceil(m/32)) uint32 words — items to exclude
    batch_size: int = 256
    user_scale: Optional[Any] = None
    item_scale: Optional[Any] = None
    use_pallas_scoring: object = "auto"
    device: DeviceLike = None
    mesh: Optional[Any] = None  # a gsrs_tpu_torch.parallel.mesh.Mesh: sharded serving

    def __post_init__(self):
        self.device = resolve_device(self.device)
        quantized = self.user_scale is not None
        table_dtype = None if quantized else torch.float32
        # on a mesh the canonical public tables stay on the host; the
        # rank's shards alone go to its device
        home = torch.device("cpu") if self.mesh is not None else self.device
        self.user_emb = _table(self.user_emb, home, table_dtype)
        self.item_emb = _table(self.item_emb, home, table_dtype)
        self.seen_bitset = bitset_to_tensor(self.seen_bitset, home)
        self._real_n = int(self.user_emb.shape[0])
        self._real_m = int(self.item_emb.shape[0])
        self._bp_perm = None
        if self.mesh is not None:
            if quantized:
                self.user_scale = _table(self.user_scale, home, torch.float32)
                self.item_scale = _table(self.item_scale, home, torch.float32)
            elif resolve_bitplane_scoring(self.use_pallas_scoring, self._real_m):
                raise ValueError("the bit-plane scoring layout is not used on a mesh (as in the "
                                 "JAX package): use_pallas_scoring 'auto' or 'off'")
            self._shard_tables()
            return
        serve_user, serve_item, serve_seen = self.user_emb, self.item_emb, self.seen_bitset
        if quantized:
            self.user_scale = _table(self.user_scale, self.device, torch.float32)
            self.item_scale = _table(self.item_scale, self.device, torch.float32)
            serve_user, serve_item = serve_user.float(), serve_item.float()
        elif resolve_bitplane_scoring(self.use_pallas_scoring, self._real_m):
            # item rows are permuted once here; result columns map back
            # through the same permutation
            m, block_m = self._real_m, BITPLANE_BLOCK_M
            m_pad = -(-m // block_m) * block_m
            perm = torch.from_numpy(bitplane_permutation(m_pad, block_m)).to(self.device)
            self._bp_perm = perm
            serve_item = F.pad(self.item_emb, (0, 0, 0, m_pad - m))[perm].contiguous()
            # widen the bitset to m_pad/32 words with every phantom column
            # set, so pad items can never surface in top-k
            W = self.seen_bitset.shape[1]
            pad = torch.full(
                (self._real_n, m_pad // 32 - W), -1, dtype=torch.int32, device=self.device
            )
            serve_seen = torch.cat([self.seen_bitset, pad], dim=1)
            if m % 32:
                high = np.array([0xFFFFFFFF << (m % 32) & 0xFFFFFFFF], np.uint32)
                serve_seen[:, W - 1] |= int(high.view(np.int32)[0])
        self._serve_tables = (serve_user, serve_item, serve_seen)

    def _shard_tables(self) -> None:
        """This rank's user rows and catalog shard of the tables padded to
        the model axis's multiple, and its shard's columns of the seen
        bitset widened to the padded catalog with every phantom column
        set."""
        from gsrs_tpu_torch.ops.bitset import bitset_columns
        from gsrs_tpu_torch.parallel.sharding import rows_of

        M, dev = self.mesh.model_size, self.device
        n_pad, m_pad = -(-self._real_n // M) * M, -(-self._real_m // M) * M
        self._u_lo, u_hi = rows_of(n_pad, self.mesh)
        self._lo, hi = rows_of(m_pad, self.mesh)

        def padded(t, rows, fill=0.0):
            return torch.cat([t, t.new_full((rows - t.shape[0], *t.shape[1:]), fill)])

        user = padded(self.user_emb, n_pad)[self._u_lo:u_hi].float()
        items = padded(self.item_emb, m_pad)[self._lo:hi].float()
        self._u_scale = self._i_scale = None
        if self.user_scale is not None:
            self._u_scale = padded(self.user_scale, n_pad, 1.0)[self._u_lo:u_hi].to(dev)
            self._i_scale = padded(self.item_scale, m_pad, 1.0)[self._lo:hi].to(dev)
        words = bitset_to_numpy(self.seen_bitset)
        seen = np.zeros((self._real_n, -(-m_pad // 32)), np.uint32)
        seen[:, : words.shape[1]] = words
        phantom = np.arange(self._real_m, m_pad)
        np.bitwise_or.at(seen.T, (phantom >> 5,),
                         (np.uint32(1) << (phantom & 31).astype(np.uint32))[:, None])
        seen_shard = bitset_columns(bitset_to_tensor(seen, torch.device("cpu")), self._lo, hi)
        self._m_pad = m_pad
        self._serve_tables = (user.to(dev), items.contiguous().to(dev), seen_shard.to(dev))

    def _mesh_topk(self, ids: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The top-k of a (b,) chunk of user ids on the mesh: each data rank
        scores its slice of the chunk, the model axis merges the catalog
        shards, the data axis gathers the slices → (b, k) on every rank."""
        from gsrs_tpu_torch.parallel.collectives import all_gather, all_reduce_
        from gsrs_tpu_torch.parallel.dist_train import sharded_topk
        from gsrs_tpu_torch.parallel.sharding import GraphShardings

        mesh = self.mesh
        b = ids.shape[0]
        ids = F.pad(ids, (0, -b % mesh.data_size))
        ids = ids[GraphShardings(mesh).batch_spec(ids.shape[0])]
        user, items, seen = self._serve_tables
        # the model axis holds the user table's rows: each rank fills the
        # rows it owns, the sum assembles them (one exact nonzero a row)
        mine = (ids >= self._u_lo) & (ids < self._u_lo + user.shape[0])
        local = (ids - self._u_lo).clamp(0, user.shape[0] - 1)
        u = torch.where(mine[:, None], user[local], 0.0)
        rescale = None
        if self._u_scale is not None:
            su = torch.where(mine, self._u_scale[local], 0.0)
            u, su = all_reduce_(torch.cat([u, su[:, None]], dim=1), mesh, "model").split(
                [u.shape[1], 1], dim=1)
            u = u.contiguous()
            i_scale = self._i_scale

            def rescale(raw):
                return torch.where(raw == NEG_INF, raw, raw * su * i_scale[None, :])
        else:
            all_reduce_(u, mesh, "model")
        vals, top = sharded_topk(u, items, seen.index_select(0, ids), k, mesh, self._lo,
                                 self._m_pad, rescale=rescale)
        return all_gather(vals, mesh, "data")[:b], all_gather(top, mesh, "data")[:b]

    @property
    def n_users(self) -> int:
        return self._real_n

    @property
    def m_items(self) -> int:
        return self._real_m

    def _score_topk(self, ids: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        ue, ie, seen = self._serve_tables
        u, rows = ue.index_select(0, ids), seen.index_select(0, ids)
        if self.user_scale is not None:
            raw = masked_scores(u, ie, rows)
            scaled = raw * self.user_scale[ids][:, None] * self.item_scale[None, :]
            return topk_scores(torch.where(raw == NEG_INF, raw, scaled), k)
        if self._bp_perm is not None:
            scores = masked_scores(u, ie, rows, bitplane=True, block_m=BITPLANE_BLOCK_M)
            vals, cols = topk_scores(scores, k)
            # phantom columns are masked; the clamp keeps ids in range
            return vals, self._bp_perm[cols].clamp_(max=self._real_m - 1)
        return masked_topk(u, ie, rows, k)

    def recommend(self, user_ids: Sequence[int], k: int = 20) -> Tuple[np.ndarray, np.ndarray]:
        """→ (items int32, scores float32), each (len(user_ids), k);
        already-seen items are excluded. Users are scored ``batch_size``
        at a time. A user with fewer than k unseen items gets item id -1
        and the −1e9 mask score in the slots left over. On a mesh every
        rank calls it; rank 0's ``user_ids`` are the request (broadcast),
        and every rank returns the answer."""
        if self.mesh is not None:
            from gsrs_tpu_torch.parallel.collectives import broadcast_object

            user_ids = broadcast_object(
                np.asarray(user_ids, dtype=np.int64) if self.mesh.is_primary else None,
                self.mesh)
        ids = np.asarray(user_ids, dtype=np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_users):
            bad = ids[(ids < 0) | (ids >= self.n_users)]
            raise ValueError(f"user ids out of range [0, {self.n_users}): {bad[:5].tolist()}")
        B = self.batch_size
        out_items = np.empty((ids.size, k), np.int32)
        out_scores = np.empty((ids.size, k), np.float32)
        for s in range(0, ids.size, B):
            chunk = torch.from_numpy(ids[s : s + B]).to(self.device)
            score = self._mesh_topk if self.mesh is not None else self._score_topk
            scores, items = score(chunk, k)
            sc = scores.cpu().numpy()
            it = items.cpu().numpy().astype(np.int32)
            # masked slots carry the −1e9 mask value, far below any real score
            out_items[s : s + B] = np.where(sc <= NEG_INF / 2, np.int32(-1), it)
            out_scores[s : s + B] = sc
        return out_items, out_scores


def retriever_from_model(
    model, data, batch_size: int = 256, device: DeviceLike = None, mesh=None
) -> Retriever:
    """Build a Retriever from a live LightGCN: one propagation + fusion,
    then the train-interaction bitset for masking. Embeddings are sliced
    back to the real node counts if ``data`` was padded. ``mesh``: the
    mesh the model was placed on (`GraphShardings.place_model`); the
    propagation runs there and the Retriever serves from it."""
    device = resolve_device(device)
    with torch.no_grad():
        if mesh is None:
            all_users, items, _ = model.final_embeddings()
        else:
            from gsrs_tpu_torch.parallel.sharding import GraphShardings

            all_users, items, _ = GraphShardings(mesh).call(model, "final_embeddings")
    n_real = getattr(data, "real_n_users", None) or data.n_users
    m_real = getattr(data, "real_m_items", None) or data.m_items
    seen = build_bitset(data.train_users, data.train_items, n_real, m_real)
    return Retriever(
        all_users[:n_real], items[:m_real], seen, batch_size=batch_size, device=device, mesh=mesh
    )


def export_embeddings(retriever: Retriever, path: str, quantize: Optional[str] = None) -> None:
    """Persist the serving artifact (post-propagation tables + bitset).

    ``quantize='int8'``: symmetric per-row absmax quantization of both
    tables; scores are then exactly (su·u_q) @ (si·i_q)^T."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    seen = bitset_to_numpy(retriever.seen_bitset)
    tables = {
        "user_emb": retriever.user_emb.cpu().numpy().astype(np.float32),
        "item_emb": retriever.item_emb.cpu().numpy().astype(np.float32),
    }
    if quantize == "int8":
        arrays = {}
        for name, t in tables.items():
            scale = np.abs(t).max(axis=1, keepdims=True) / 127.0
            scale = np.where(scale > 0, scale, 1.0)
            arrays[name + "_q"] = np.clip(np.rint(t / scale), -127, 127).astype(np.int8)
            arrays[name + "_scale"] = scale.astype(np.float32)[:, 0]
        np.savez_compressed(path, seen_bitset=seen, **arrays)
        return
    np.savez_compressed(path, seen_bitset=seen, **tables)


def load_retriever(
    path: str,
    batch_size: int = 256,
    use_pallas_scoring: object = "auto",
    device: DeviceLike = None,
    mesh=None,
) -> Retriever:
    """Load an npz artifact written by either package onto ``device`` (on
    a ``mesh``, this rank's shards onto its device)."""
    with np.load(path) as z:
        if "user_emb_q" in z.files:  # int8-quantized artifact
            return Retriever(
                z["user_emb_q"],
                z["item_emb_q"],
                z["seen_bitset"],
                batch_size=batch_size,
                user_scale=z["user_emb_scale"],
                item_scale=z["item_emb_scale"],
                device=device,
                mesh=mesh,
            )
        return Retriever(
            z["user_emb"],
            z["item_emb"],
            z["seen_bitset"],
            batch_size=batch_size,
            use_pallas_scoring=use_pallas_scoring,
            device=device,
            mesh=mesh,
        )


# --------------------------------------------------------------------- CLI


def model_config_from_meta(meta: dict):
    """A `ModelConfig` from ``model_meta.json`` written by either package
    (JSON lists become the dataclass's tuples)."""
    from gsrs_tpu_torch.config import ModelConfig

    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in meta.items()})


def export_checkpoint(args) -> Retriever:
    """``serve export``: checkpoint → artifact. → the Retriever written."""
    import json
    import os

    import scipy.sparse as sp

    from gsrs_tpu_torch.config import ModelConfig
    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.data.dataset import load_dataset
    from gsrs_tpu_torch.models.lightgcn import ItemItemGraph
    from gsrs_tpu_torch.cli import layout_from_interactions
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.train.checkpoint import CheckpointManager, legacy_name

    device = resolve_device(args.device)
    data = load_dataset(args.dataset_dir)
    if args.model_axis > 1:
        from gsrs_tpu_torch.data.dataset import pad_nodes_to_multiple

        # the graph a mesh run of this model axis trained on (its pop
        # features count the phantom items); the artifact is cut back
        data = pad_nodes_to_multiple(data, args.model_axis)
    graph = build_graph(data, cache_dir=args.dataset_dir)
    # the model config the trainer wrote beside its checkpoints; the flags
    # only for a run that left none
    meta_path = os.path.join(args.checkpoint_dir, "model_meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            cfg = model_config_from_meta(json.load(f))
        print(f"[serve] using {meta_path}")
    else:
        cfg = ModelConfig(
            model=args.model, num_layers=args.layer, embedding_dim=args.recdim,
            bf16_compute=args.bf16, use_pop_gate=args.use_pop_gate,
            pop_hidden=args.pop_hidden, gate_hidden=args.gate_hidden,
            pop_gate_temp=args.pop_gate_temp, use_item_item=args.use_item_item,
            i2i_path=args.i2i_path, i2i_alpha=args.i2i_alpha,
        )
    i2i = None
    if cfg.use_item_item and (cfg.i2i_path or args.i2i_path):
        i2i = ItemItemGraph.from_scipy(sp.load_npz(cfg.i2i_path or args.i2i_path))
    # the propagation runs on the ELL layout whatever layout trained it:
    # every layout computes the same product
    cfg = dataclasses.replace(cfg, spmm_mode="ell")
    model = build_model(cfg, graph, i2i=i2i, ell=layout_from_interactions(cfg, data),
                        device=device)
    ckpt = CheckpointManager(args.checkpoint_dir)
    path = ckpt.resolve_resume_path(
        None, legacy_name(cfg.model, data.name, cfg.num_layers, cfg.embedding_dim))
    if path is None:
        raise SystemExit(f"no checkpoint under {args.checkpoint_dir}")
    params = ckpt.restore(path)["params"]
    missing = set(model.state_dict()) - set(params)
    if missing:
        raise ValueError(f"the checkpoint at {path} lacks {sorted(missing)}")
    from gsrs_tpu_torch.parallel.mesh import single_device_mesh
    from gsrs_tpu_torch.parallel.sharding import take_rows

    # the checkpoint's tables hold the real rows; phantom rows keep theirs
    state = model.state_dict()
    mesh = single_device_mesh(device)
    model.load_state_dict({k: take_rows(params[k], v.shape[0], mesh, v)
                           if k in ("user_emb", "item_emb") else params[k]
                           for k, v in state.items()})
    r = retriever_from_model(model, data, device=device)
    export_embeddings(r, args.out, quantize=args.quantize)
    q = f" ({args.quantize})" if args.quantize else ""
    print(f"[serve] exported {args.out}: {r.n_users} users × {r.m_items} items{q}")
    return r


def main(argv: Optional[list] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(prog="gsrs_tpu_torch.serve")
    sub = ap.add_subparsers(dest="cmd", required=True)

    exp = sub.add_parser("export", help="checkpoint → serving artifact")
    exp.add_argument("--checkpoint_dir", required=True)
    exp.add_argument("--dataset_dir", required=True)
    exp.add_argument("--out", required=True)
    exp.add_argument("--model_axis", type=int, default=1,
                     help="the model axis the run trained with (its nodes were padded to a "
                     "multiple of it); the artifact is cut back to the real counts")
    exp.add_argument("--model", default="lgn")
    exp.add_argument("--quantize", choices=["int8"], default=None,
                     help="int8 per-row quantized tables, scored exactly in fp32")
    exp.add_argument("--layer", type=int, default=3)
    exp.add_argument("--recdim", type=int, default=64)
    exp.add_argument("--bf16", action="store_true")
    # used only without model_meta.json: they must match the training run
    exp.add_argument("--use_pop_gate", action="store_true")
    exp.add_argument("--pop_hidden", type=int, default=32)
    exp.add_argument("--gate_hidden", type=int, default=64)
    exp.add_argument("--pop_gate_temp", type=float, default=1.0)
    exp.add_argument("--use_item_item", action="store_true")
    exp.add_argument("--i2i_path", default=None)
    exp.add_argument("--i2i_alpha", type=float, default=0.1)
    exp.add_argument("--device", default=None, help="torch device (default cuda:0)")

    qry = sub.add_parser("query", help="artifact → recommendations")
    qry.add_argument("--artifact", required=True)
    qry.add_argument("--users", type=int, nargs="+", required=True)
    qry.add_argument("--k", type=int, default=20)
    qry.add_argument(
        "--use_pallas_scoring", choices=["auto", "on", "off"], default="auto",
        help="'on' scores in the bit-plane layout; 'auto' and 'off' in natural order",
    )
    qry.add_argument("--device", default=None, help="torch device (default cuda:0)")
    qry.add_argument("--model_axis", type=int, default=1,
                     help="shard the catalog over this many ranks (started here)")
    from gsrs_tpu_torch.cli import add_backend_flag, launch_if_needed

    add_backend_flag(qry)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    if args.cmd == "export":
        export_checkpoint(args)
        return
    if launch_if_needed(_rank_entry, argv, args.model_axis, args.dist_backend, args.device):
        return
    query(args, device=args.device)


def _rank_entry(device, argv) -> None:
    ap_args = list(argv)
    if "--device" in ap_args:  # the rank's device replaces the parent's
        i = ap_args.index("--device")
        del ap_args[i:i + 2]
    main(ap_args + ["--device", str(device)])


def query(args, device: DeviceLike = None) -> None:
    """``serve query``: the artifact's top-k for ``--users`` (on a mesh,
    rank 0 prints)."""
    mesh = None
    if args.model_axis > 1:
        from gsrs_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(data_axis=1, model_axis=args.model_axis, device=resolve_device(device))
    r = load_retriever(args.artifact, use_pallas_scoring=args.use_pallas_scoring, device=device,
                       mesh=mesh)
    items, scores = r.recommend(args.users, k=args.k)
    if mesh is not None and not mesh.is_primary:
        return
    for u, its, scs in zip(args.users, items, scores):
        pairs = " ".join(f"{i}:{s:.3f}" for i, s in zip(its, scs))
        print(f"user {u}: {pairs}")


if __name__ == "__main__":
    main()
