"""Stateless counter-based per-edge dropout (port of `gsrs_tpu.ops.hashdrop`).

The keep decision for edge (u, i) at a given step is a pure 32-bit hash
of (u, i, step key), computable elementwise in any edge layout: the
tiled layout's dense hub cells, where (dst, top_src[c]) names the edge
but no per-cell edge index exists, and canonical edge lists. Every
layout that sees the same (u, i, key) makes the same decision, so both
propagation directions and the dense/residual split drop the same edges.

Mixer: two distinct odd-constant multiplies fold (u, key0) and (i, key1)
into one word, then the lowbias32 finalizer. The top 24 bits compare
exactly in float32 against keep_prob. The uint32 arithmetic runs in
int64 and is cut to 32 bits after every multiply and add; a multiply by
a 32-bit constant goes through its two 16-bit halves so that no product
leaves int64's range. So the bits are the JAX package's, on the CPU and
on the card, with no reliance on integer overflow.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

# (k0, k1, keep_prob): two key words in [0, 2**32) as int64 scalars (ints
# or 0-dim tensors on the mask's device) and the keep probability
HashDrop = Tuple[Union[int, torch.Tensor], Union[int, torch.Tensor], float]

_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h · c) mod 2**32 for int64 h in [0, 2**32) and a 32-bit constant c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def hashdrop_from_generator(generator: torch.Generator, keep_prob: float) -> HashDrop:
    """Draw the two key words from ``generator``, on its device (no host
    read). The JAX package derives them from a PRNG key instead, so the
    two streams differ; parity tests pass explicit words to both."""
    words = torch.randint(0, 2**32, (2,), generator=generator, dtype=torch.int64,
                          device=generator.device)
    return (words[0], words[1], float(keep_prob))


def hash_keep(
    u: torch.Tensor,
    i: torch.Tensor,
    drop: HashDrop,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Inverted-dropout mask over the broadcast shape of (u, i):
    1/keep_prob where the edge survives, 0 where dropped."""
    k0, k1, keep_prob = drop
    x = (_mul32(u.long() & _M32, 0x9E3779B1) + k0) & _M32
    y = (_mul32(i.long() & _M32, 0x85EBCA77) + k1) & _M32
    h = x ^ y
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    # top 24 bits are exact in f32; uniform in [0, 1)
    unit = (h >> 8).float() * (1.0 / (1 << 24))
    kp = np.float32(keep_prob)  # compared and inverted in float32, as in JAX
    return torch.where(unit < float(kp), float(np.float32(1.0) / kp), 0.0).to(dtype)


def canonical_hash_mask(
    users: torch.Tensor,
    items: torch.Tensor,
    drop: Optional[HashDrop],
    dtype: torch.dtype = torch.float32,
) -> Optional[torch.Tensor]:
    """Mask in canonical edge order, for cross-layout equality tests and
    the residual edge lists of the tiled layout."""
    if drop is None:
        return None
    return hash_keep(users, items, drop, dtype)
