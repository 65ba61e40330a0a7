"""Session serving for the sequential family (port of
`gsrs_tpu.serve_seq`).

Given any item-id history (a session, not a known user), encode it and
return the top-k next items with the session's own items excluded. The
query is the session, so nothing is precomputed per user: the artifact
holds the model's hyperparameters and parameters, and each request chunk
runs the encoder, one launch of the masked-scoring CUDA kernel
(`gsrs_tpu_torch.ops.scoring`, K1) over the real item rows with the
session's seen-items bitset, and the exact top-k in ``lax.top_k``'s
order (`gsrs_tpu_torch.ops.topk.exact_topk`). The query and the rows
are the model's `scoring_query` and `scoring_catalog`: for BERT4Rec's
Eq. 7 head, (GELU(h·W^P + b^P) ‖ 1) against (E ‖ b^O). HSTU is refused
(`refuse_timed`): it scores a history with its items' times, which a
request does not carry.

CLI:
  python -m gsrs_tpu_torch.serve_seq export --checkpoint_dir ckpts --out seq.npz
  python -m gsrs_tpu_torch.serve_seq query --artifact seq.npz --session 3 17 42 --k 10

Both run on ``cuda:0`` unless ``--device`` says otherwise. Sessions are
real 0-based item ids (the dataset files' id space); the +1 shift with
PAD = 0 is internal, as in `gsrs_tpu_torch.data.sequences`. The artifact
is the JAX package's npz (``__meta__`` JSON and ``param/<name>``
arrays): either package serves the other's.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gsrs_tpu_torch.device import DeviceLike, resolve_device
from gsrs_tpu_torch.models.registry import SEQ_MODELS, seq_model_from_meta
from gsrs_tpu_torch.ops.bitset import bitset_to_tensor, build_bitset
from gsrs_tpu_torch.ops.linalg import fp32_reduction
from gsrs_tpu_torch.ops.scoring import masked_scores
from gsrs_tpu_torch.ops.topk import topk_scores


@dataclasses.dataclass
class SeqRetriever:
    """Serves next-item top-k from a trained sequential model on
    ``device`` (default ``cuda:0``). ``params`` (names → arrays or
    tensors, e.g. an artifact's), when given, are loaded into ``model``;
    otherwise the model's own parameters serve."""

    model: torch.nn.Module  # SASRec | GRU4Rec | BERT4Rec
    params: Optional[dict] = None
    batch_size: int = 64
    device: DeviceLike = None

    def __post_init__(self):
        refuse_timed(self.model)
        self.device = resolve_device(self.device)
        self.model = self.model.to(self.device)
        if self.params is not None:
            self.model.load_state_dict({
                k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
                for k, v in self.params.items()})
        self.params = self.model.params()

    @property
    def m_items(self) -> int:
        return int(self.model.cfg.m_items)

    @property
    def max_len(self) -> int:
        return int(self.model.cfg.max_len)

    def _encode_sessions(
        self, sessions: Sequence[Sequence[int]]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """→ (seqs (N, max_len) shifted and left-padded, the seen bitset
        (N, W) uint32). Ids are range-checked here, on the host."""
        L, m = self.max_len, self.m_items
        n = len(sessions)
        seqs = np.zeros((n, L), np.int32)
        id_arrays = []
        for r, sess in enumerate(sessions):
            ids = np.asarray(list(sess), dtype=np.int64)
            if ids.size == 0:
                raise ValueError(f"session {r} is empty")
            if ids.min() < 0 or ids.max() >= m:
                bad = ids[(ids < 0) | (ids >= m)]
                raise ValueError(
                    f"session {r}: item ids out of range [0, {m}): {bad[:5].tolist()}")
            tail = ids[-L:]
            seqs[r, L - tail.size:] = tail.astype(np.int32) + 1  # shift, PAD = 0
            id_arrays.append(ids)
        rows = np.repeat(np.arange(n, dtype=np.int64), [a.size for a in id_arrays])
        seen = build_bitset(rows, np.concatenate(id_arrays) if id_arrays
                            else np.zeros(0, np.int64), n, m)
        return seqs, seen

    @torch.no_grad()
    def recommend(
        self, sessions: Sequence[Sequence[int]], k: int = 20
    ) -> Tuple[np.ndarray, np.ndarray]:
        """→ (items int32, scores float32), each (len(sessions), k), 0-based
        real ids; a session's own items are excluded. Sessions are scored
        ``batch_size`` at a time, each chunk at its own size (JAX pads the
        last chunk to ``batch_size``; the rows are independent, so the
        results are the same)."""
        seqs, seen = self._encode_sessions(sessions)
        n, B = seqs.shape[0], self.batch_size
        out_items = np.empty((n, k), np.int32)
        out_scores = np.empty((n, k), np.float32)
        for s in range(0, n, B):
            cs = torch.from_numpy(seqs[s:s + B]).long().to(self.device)
            top_s, top_i = self._score_topk(cs, bitset_to_tensor(seen[s:s + B], self.device), k)
            out_items[s:s + B] = top_i.cpu().numpy()
            out_scores[s:s + B] = top_s.cpu().numpy()
        return out_items, out_scores

    @torch.no_grad()
    def _score_topk(self, seqs: torch.Tensor, seen_rows: torch.Tensor,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """One chunk on the device: the encoder over ``seqs`` (b, max_len),
        K1 over the real item rows with ``seen_rows`` (b, W) masked, and
        the top-k → (scores, 0-based item ids), each (b, k)."""
        with fp32_reduction():
            q = self.model.scoring_query(seqs).contiguous()
            return topk_scores(masked_scores(q, self.model.scoring_catalog(), seen_rows), k)


def refuse_timed(model) -> None:
    """Raise for a model that scores a history with its times (HSTU): a
    request carries item ids alone."""
    if getattr(model, "uses_times", False):
        raise ValueError(f"{type(model).__name__} is not served: it scores a history with each "
                         f"item's time, and a request carries item ids alone")


def export_seq_model(
    params: dict,
    kind: str,
    m_items: int,
    path: str,
    max_len: int = 50,
    dim: int = 64,
    hidden: int = 64,
    blocks: int = 2,
    heads: int = 1,
    published: int = 0,
) -> None:
    """A self-contained serving artifact: the hyperparameters (JSON meta)
    and the parameters (``param/<name>``) in one npz, the JAX package's
    layout; BERT4Rec's ``published`` joins the meta where it is set."""
    if kind not in SEQ_MODELS:
        raise ValueError(f"unknown sequential model '{kind}'")
    meta = {"kind": kind, "m_items": int(m_items), "max_len": int(max_len), "dim": int(dim),
            "hidden": int(hidden), "blocks": int(blocks), "heads": int(heads)}
    if published:
        meta["published"] = int(published)
    arrays = {f"param/{k}": (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                             else np.asarray(v)) for k, v in params.items()}
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def load_seq_retriever(path: str, batch_size: int = 64,
                       device: DeviceLike = None) -> SeqRetriever:
    """A `SeqRetriever` of an artifact written by either package."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        params = {k[len("param/"):]: z[k] for k in z.files if k.startswith("param/")}
    model = seq_model_from_meta(meta, dropout=0.0, device="cpu")
    return SeqRetriever(model, params, batch_size=batch_size, device=device)


# --------------------------------------------------------------------- CLI


def export_checkpoint(args) -> None:
    """``export``: the newest checkpoint → an artifact, the hyperparameters
    from ``model_meta.json`` beside the checkpoints (the flags, or
    ``--dataset_dir`` for the item count, only for a run that left none:
    some, e.g. ``--heads``, do not change parameter shapes, so a wrong
    flag would serve wrongly without an error)."""
    import os

    from gsrs_tpu_torch.train.checkpoint import CheckpointManager

    meta_path = os.path.join(args.checkpoint_dir, "model_meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            tm = json.load(f)
        print(f"[serve_seq] using {meta_path}: {tm}")
    else:
        m_items = args.m_items
        if m_items is None:
            if args.dataset_dir is None:
                raise SystemExit("pass --m_items or --dataset_dir")
            from gsrs_tpu_torch.data.dataset import load_dataset

            m_items = load_dataset(args.dataset_dir).m_items
        tm = {"kind": args.model, "m_items": m_items, "max_len": args.max_len, "dim": args.dim,
              "hidden": args.hidden, "blocks": args.blocks, "heads": args.heads}
    kind = tm["kind"]
    model = seq_model_from_meta(tm, device=resolve_device(args.device))
    refuse_timed(model)
    ckpt = CheckpointManager(args.checkpoint_dir)
    path = ckpt.resolve_resume_path(None)
    if path is None:
        raise SystemExit(f"no checkpoint under {args.checkpoint_dir}")
    # a checkpoint holds {params, opt_state, epoch}: the parameters serve
    model.load_state_dict(ckpt.restore(path)["params"])
    export_seq_model(model.params(), kind, tm["m_items"], args.out, max_len=tm["max_len"],
                     dim=tm["dim"], hidden=tm["hidden"], blocks=tm["blocks"],
                     heads=tm["heads"], published=tm.get("published", 0))
    print(f"[serve_seq] exported {args.out}: {kind}, {tm['m_items']} items")


def main(argv: Optional[list] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(prog="gsrs_tpu_torch.serve_seq")
    sub = ap.add_subparsers(dest="cmd", required=True)

    exp = sub.add_parser("export", help="seq checkpoint → serving artifact")
    exp.add_argument("--checkpoint_dir", required=True)
    exp.add_argument("--out", required=True)
    exp.add_argument("--model", choices=list(SEQ_MODELS), default="sasrec")
    # used only without model_meta.json: they must match the training run
    exp.add_argument("--m_items", type=int, default=None)
    exp.add_argument("--dataset_dir", default=None, help="infer m_items from data")
    exp.add_argument("--max_len", type=int, default=50)
    exp.add_argument("--dim", type=int, default=64)
    exp.add_argument("--hidden", type=int, default=64)
    exp.add_argument("--blocks", type=int, default=2)
    exp.add_argument("--heads", type=int, default=1)
    exp.add_argument("--device", default=None, help="torch device (default cuda:0)")

    qry = sub.add_parser("query", help="artifact + session → next items")
    qry.add_argument("--artifact", required=True)
    qry.add_argument("--session", type=int, nargs="+", required=True,
                     help="item ids, oldest first (0-based real ids)")
    qry.add_argument("--k", type=int, default=20)
    qry.add_argument("--device", default=None, help="torch device (default cuda:0)")

    args = ap.parse_args(argv)
    if args.cmd == "export":
        export_checkpoint(args)
        return
    # one-shot query: a batch of exactly 1
    r = load_seq_retriever(args.artifact, batch_size=1, device=args.device)
    items, scores = r.recommend([args.session], k=args.k)
    pairs = " ".join(f"{i}:{s:.3f}" for i, s in zip(items[0], scores[0]))
    print(f"session {args.session}: {pairs}")


if __name__ == "__main__":
    main()
