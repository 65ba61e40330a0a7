"""Retrieval serving: precomputed embeddings + masked top-k on the card
(port of `gsrs_tpu.serve`).

- ``Retriever``: propagation has run once, before it is built; each
  request is a gather of user rows, one launch of the masked-scoring
  CUDA kernel (`gsrs_tpu_torch.ops.scoring`) and `torch.topk`.
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
otherwise. Not ported yet: sharded serving (``mesh``/``--model_axis``,
ROADMAP.md A7).
"""

from __future__ import annotations

import dataclasses
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

    def __post_init__(self):
        self.device = resolve_device(self.device)
        quantized = self.user_scale is not None
        table_dtype = None if quantized else torch.float32
        self.user_emb = _table(self.user_emb, self.device, table_dtype)
        self.item_emb = _table(self.item_emb, self.device, table_dtype)
        self.seen_bitset = bitset_to_tensor(self.seen_bitset, self.device)
        self._real_n = int(self.user_emb.shape[0])
        self._real_m = int(self.item_emb.shape[0])
        self._bp_perm = None
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
        and the −1e9 mask score in the slots left over."""
        ids = np.asarray(user_ids, dtype=np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_users):
            bad = ids[(ids < 0) | (ids >= self.n_users)]
            raise ValueError(f"user ids out of range [0, {self.n_users}): {bad[:5].tolist()}")
        B = self.batch_size
        out_items = np.empty((ids.size, k), np.int32)
        out_scores = np.empty((ids.size, k), np.float32)
        for s in range(0, ids.size, B):
            chunk = torch.from_numpy(ids[s : s + B]).to(self.device)
            scores, items = self._score_topk(chunk, k)
            sc = scores.cpu().numpy()
            it = items.cpu().numpy().astype(np.int32)
            # masked slots carry the −1e9 mask value, far below any real score
            out_items[s : s + B] = np.where(sc <= NEG_INF / 2, np.int32(-1), it)
            out_scores[s : s + B] = sc
        return out_items, out_scores


def retriever_from_model(
    model, data, batch_size: int = 256, device: DeviceLike = None
) -> Retriever:
    """Build a Retriever from a live LightGCN: one propagation + fusion,
    then the train-interaction bitset for masking. Embeddings are sliced
    back to the real node counts if ``data`` was padded."""
    device = resolve_device(device)
    with torch.no_grad():
        all_users, items, _ = model.final_embeddings()
    n_real = getattr(data, "real_n_users", None) or data.n_users
    m_real = getattr(data, "real_m_items", None) or data.m_items
    seen = build_bitset(data.train_users, data.train_items, n_real, m_real)
    return Retriever(
        all_users[:n_real], items[:m_real], seen, batch_size=batch_size, device=device
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
) -> Retriever:
    """Load an npz artifact written by either package onto ``device``."""
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
            )
        return Retriever(
            z["user_emb"],
            z["item_emb"],
            z["seen_bitset"],
            batch_size=batch_size,
            use_pallas_scoring=use_pallas_scoring,
            device=device,
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

    if args.model_axis > 1:
        raise NotImplementedError("serve export --model_axis > 1 (a checkpoint of a mesh run) "
                                  "is not ported yet (ROADMAP.md A7)")
    device = resolve_device(args.device)
    data = load_dataset(args.dataset_dir)
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
    model.load_state_dict({k: params[k] for k in model.state_dict()})
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
                     help="the mesh's model axis the run trained with (only 1 is ported)")
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
    args = ap.parse_args(argv)
    if args.cmd == "export":
        export_checkpoint(args)
        return

    r = load_retriever(
        args.artifact, use_pallas_scoring=args.use_pallas_scoring, device=args.device
    )
    items, scores = r.recommend(args.users, k=args.k)
    for u, its, scs in zip(args.users, items, scores):
        pairs = " ".join(f"{i}:{s:.3f}" for i, s in zip(its, scs))
        print(f"user {u}: {pairs}")


if __name__ == "__main__":
    main()
