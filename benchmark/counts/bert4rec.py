"""The work of one published-BERT4Rec training step, counted from the
configuration's shapes (batch B, sequence length N, width d, FFN width
f, blocks, slots a sequence P, items m), whatever implements it.

Operations (forward; backward twice as many, the step three times):

- a block, over T = B·N tokens: the Q, K, V and output projections
  4·2·T·d², the FFN 2·2·T·d·f, the attention's two products 2·2·T·N·d;
- the head, over the S = B·P slots computed (the empty slots too): the
  projection 2·S·d² and the logits against the catalog 2·S·d·m.

Bytes: the slot × item logits read once and their gradient written once
(the cross-entropy's least traffic, `xent_least_s`), and Adam's p, m, v,
g read and p, m, v written over every parameter.
"""

from __future__ import annotations

from benchmark.counts.peaks import HBM_BYTES_PER_S, least_s


def _shapes(cfg: dict):
    m = cfg["model"]
    B = cfg["train"]["batch_size"]
    return (B, m["max_len"], m["embedding_dim"], m["ffn_hidden"], m["num_blocks"],
            m["max_predictions"], cfg["data"]["m_items"])


def params(cfg: dict) -> int:
    """The model's parameter count."""
    B, N, d, f, L, P, m = _shapes(cfg)
    block = 4 * d * d + 2 * d * f + f + d + 4 * d
    return (m + 2) * d + N * d + L * block + d * d + d + m


def step_flops(cfg: dict) -> float:
    B, N, d, f, L, P, m = _shapes(cfg)
    T, S = B * N, B * P
    block = 8.0 * T * d * d + 4.0 * T * d * f + 4.0 * T * N * d
    head = 2.0 * S * d * d + 2.0 * S * d * m
    return 3.0 * (L * block + head)


def xent_bytes(cfg: dict) -> float:
    """The slot × item logits read once and their gradient written once,
    in float32."""
    B, N, d, f, L, P, m = _shapes(cfg)
    return 2 * 4.0 * B * P * m


def xent_least_s(cfg: dict) -> float:
    """The cross-entropy's least time a step: its bytes at the HBM rate."""
    return xent_bytes(cfg) / HBM_BYTES_PER_S


def train_step_least(cfg: dict):
    """(seconds, bound) of one training step in float32."""
    return least_s(step_flops(cfg), xent_bytes(cfg) + 7 * 4.0 * params(cfg), "float32")
