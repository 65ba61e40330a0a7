"""Model registry (port of `gsrs_tpu.models.registry`): the graph family's
`build_model` and the sequential family's `build_seq_model`."""

from __future__ import annotations

from typing import Optional

import torch

from gsrs_tpu_torch.config import ModelConfig
from gsrs_tpu_torch.data.adjacency import BipartiteGraph
from gsrs_tpu_torch.device import DeviceLike
from gsrs_tpu_torch.models.lightgcn import ItemItemGraph, Layout, LightGCN
from gsrs_tpu_torch.models.mf import PureMF
from gsrs_tpu_torch.models.ngcf import NGCF
from gsrs_tpu_torch.models.ultragcn import UltraGCN
from gsrs_tpu_torch.models.xsimgcl import XSimGCL

MODELS = {
    "lgn": LightGCN,
    "mf": PureMF,
    "ngcf": NGCF,
    "xsimgcl": XSimGCL,
    "ultragcn": UltraGCN,
}


def build_model(
    cfg: ModelConfig,
    graph: BipartiteGraph,
    i2i: Optional[ItemItemGraph] = None,
    ell: Optional[Layout] = None,
    device: DeviceLike = None,
    generator: Optional[torch.Generator] = None,
    cache_dir: Optional[str] = None,
) -> LightGCN:
    """Build the configured model on ``device`` (default ``cuda:0``);
    ``i2i`` and ``ell`` as in the JAX package's `build_model`.
    ``cache_dir`` (the dataset directory) holds UltraGCN's item–item top-K
    cache."""
    if cfg.model not in MODELS:
        raise ValueError(
            f"model '{cfg.model}' is not registered; available: {sorted(MODELS)}"
        )
    kw = dict(i2i=i2i, ell=ell, device=device, generator=generator)
    if cfg.model == "ultragcn":
        return UltraGCN(cfg, graph, ii_cache_dir=cache_dir, **kw)
    return MODELS[cfg.model](cfg, graph, **kw)


SEQ_MODELS = ("sasrec", "gru4rec", "bert4rec")  # the JAX package's, and the port's
PORT_SEQ_MODELS = SEQ_MODELS + ("hstu",)  # and the port's own


def build_seq_model(
    kind: str,
    m_items: int,
    max_len: int = 50,
    dim: int = 64,
    hidden: int = 64,
    blocks: int = 2,
    heads: int = 1,
    dropout: float = 0.2,
    bf16: bool = False,
    mask_prob: float = 0.3,
    last_only_prob: float = 0.6,
    published: int = 0,
    device: DeviceLike = None,
    generator: Optional[torch.Generator] = None,
):
    """The sequential model ``kind`` on ``device`` (default ``cuda:0``),
    its parameters drawn from the CPU ``generator`` (seed 0 when None):
    the one place that maps the flat CLI and serving hyperparameters onto
    each model's config. ``blocks`` is GRU4Rec's layer count, ``hidden``
    its hidden width. ``published``: BERT4Rec as published, with that many
    prediction slots a sequence (`models.bert4rec`). HSTU (`models.hstu`):
    ``hidden`` is a head's width (d_qk = d_v)."""
    kw = dict(device=device, generator=generator)
    if published and kind != "bert4rec":
        raise ValueError(f"published is BERT4Rec's option, not {kind}'s")
    if kind == "hstu":
        from gsrs_tpu_torch.models.hstu import HSTU, HSTUConfig

        if bf16:
            raise ValueError("HSTU runs in float32: bf16 is not an option of it")
        return HSTU(HSTUConfig(
            m_items=m_items, max_len=max_len, embedding_dim=dim, num_blocks=blocks,
            num_heads=heads, head_dim=hidden, dropout_rate=dropout), **kw)
    if kind == "sasrec":
        from gsrs_tpu_torch.models.sasrec import SASRec, SASRecConfig

        return SASRec(SASRecConfig(
            m_items=m_items, max_len=max_len, embedding_dim=dim, num_blocks=blocks,
            num_heads=heads, ffn_hidden=hidden, dropout_rate=dropout, bf16_compute=bf16), **kw)
    if kind == "bert4rec":
        from gsrs_tpu_torch.models.bert4rec import BERT4Rec, BERT4RecConfig

        return BERT4Rec(BERT4RecConfig(
            m_items=m_items, max_len=max_len, embedding_dim=dim, num_blocks=blocks,
            num_heads=heads, ffn_hidden=hidden, dropout_rate=dropout, mask_prob=mask_prob,
            last_only_prob=last_only_prob, bf16_compute=bf16, published=published), **kw)
    if kind == "gru4rec":
        from gsrs_tpu_torch.models.gru4rec import GRU4Rec, GRU4RecConfig

        return GRU4Rec(GRU4RecConfig(
            m_items=m_items, max_len=max_len, embedding_dim=dim, hidden_dim=hidden,
            num_layers=blocks, dropout_rate=dropout, bf16_compute=bf16), **kw)
    raise ValueError(
        f"sequential model '{kind}' is not registered; available: {sorted(PORT_SEQ_MODELS)}"
    )


META_KEYS = ("m_items", "max_len", "dim", "hidden", "blocks", "heads")


def seq_model_meta(model) -> dict:
    """The flat hyperparameters of a sequential model, `build_seq_model`'s
    inverse, as ``model_meta.json`` and serving artifacts hold them (the
    JAX package's keys; ``kind`` is the class name, lower-cased), and
    ``published`` where it is set."""
    c = model.cfg
    meta = {
        "kind": type(model).__name__.lower(),
        "m_items": int(c.m_items),
        "max_len": int(c.max_len),
        "dim": int(c.embedding_dim),
        "hidden": int(getattr(c, "ffn_hidden", 0) or getattr(c, "hidden_dim", 0)
                      or getattr(c, "head_dim", 0)),
        "blocks": int(getattr(c, "num_blocks", 0) or getattr(c, "num_layers", 0)),
        "heads": int(getattr(c, "num_heads", 1)),
    }
    if getattr(c, "published", 0):
        meta["published"] = int(c.published)
    return meta


def seq_model_from_meta(meta: dict, **kw):
    """`build_seq_model` of a meta (`seq_model_meta`'s), ``kw`` added."""
    return build_seq_model(meta["kind"], **{k: meta[k] for k in META_KEYS},
                           published=meta.get("published", 0), **kw)
