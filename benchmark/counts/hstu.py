"""The work of one HSTU training step (`benchmark.reference.hstu`),
counted from the configuration's shapes (width d, H heads of width d_h,
blocks L, negatives K, items m) and the step's real slots, whatever
implements it: the padding a program computes is not counted.

A step's real slots: ``real_slots``, its slots with a real input and a
real target (the loss's), and ``causal_pairs``, its (query, key) pairs of
real inputs with the key not after the query; both counted from the
benchmark's own sequences (`benchmark.loops.hstu_train.slot_counts`).

Operations (forward; backward twice as many, the step three times):

- a block, at each real slot: W₁ 2·d·4·H·d_h and W₂ 2·H·d_h·d; at each
  causal pair the two products Q·K and A·V, 2·2·H·d_h;
- the head, at each real slot: its 1 + K dot products of width d.

Bytes: the head's 1 + K rows a real slot read once and their gradient
written once (float32), and Adam's p, m, v, g read and p, m, v written
over every parameter.
"""

from __future__ import annotations

from benchmark.counts.peaks import least_s


def _shapes(cfg: dict):
    m = cfg["model"]
    return (m["embedding_dim"], m["num_heads"] * m["head_dim"], m["num_blocks"],
            m["num_negatives"], m["max_len"], cfg["data"]["m_items"])


def params(cfg: dict) -> int:
    """The model's parameter count."""
    d, W, L, K, N, m = _shapes(cfg)
    block = d * 4 * W + W * d + d + (2 * N - 1) + 129
    return (m + 1) * d + N * d + L * block


def step_flops(cfg: dict, real_slots: float, causal_pairs: float) -> float:
    d, W, L, K, N, m = _shapes(cfg)
    block = real_slots * (2.0 * d * 4 * W + 2.0 * W * d) + causal_pairs * 4.0 * W
    head = real_slots * 2.0 * (1 + K) * d
    return 3.0 * (L * block + head)


def step_bytes(cfg: dict, real_slots: float) -> float:
    d, W, L, K, N, m = _shapes(cfg)
    return 2 * 4.0 * real_slots * (1 + K) * d + 7 * 4.0 * params(cfg)


def train_step_least(cfg: dict, real_slots: float, causal_pairs: float):
    """(seconds, bound) of one training step in float32."""
    return least_s(step_flops(cfg, real_slots, causal_pairs), step_bytes(cfg, real_slots),
                   "float32")
