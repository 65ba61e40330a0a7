"""Host-side batching and shuffling (numpy copy of
`gsrs_tpu.utils.batching`).

The training paths batch on the device; these helpers keep the JAX
package's host API. `minibatch` yields the ragged tail batch as the
reference does."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def minibatch(*tensors: np.ndarray, batch_size: int = 2048) -> Iterator:
    """Aligned slices of the inputs, the ragged tail included."""
    n = len(tensors[0])
    for start in range(0, n, batch_size):
        if len(tensors) == 1:
            yield tensors[0][start:start + batch_size]
        else:
            yield tuple(t[start:start + batch_size] for t in tensors)


def shuffle(
    *arrays: np.ndarray, rng: np.random.Generator | None = None
) -> Tuple[np.ndarray, ...]:
    """One permutation applied to every input (a single input comes back
    alone, not in a tuple)."""
    if len({len(a) for a in arrays}) != 1:
        raise ValueError("all inputs must have the same length")
    rng = rng or np.random.default_rng()
    perm = rng.permutation(len(arrays[0]))
    out = tuple(a[perm] for a in arrays)
    return out[0] if len(out) == 1 else out
