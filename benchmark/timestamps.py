"""Each slot's time for the sequential cells whose model reads times
(HSTU), made from ``--seed`` over the histories `benchmark.sequences`
makes: a stand-in, since the real ratings, and so their timestamps, are
not in the repository. Its rates have no source: they are placeholders,
to be replaced by ML-20M's own timestamps once its ratings are in the
repository.

The law (the configuration's ``data.times``, in seconds):

- between a sequence's items, gaps from a two-part law: with probability
  ``session_p`` the same session, a gap log-uniform over
  ``in_session_s`` (seconds to minutes), else a new session, a gap
  log-uniform over ``between_sessions_s`` (hours to years); gaps are
  whole seconds;
- its first real slot at a time uniform over [``start``, ``end`` − G],
  G the sum of its gaps, so that every time lies in [``start``,
  ``end``], ML-20M's span. A history whose gaps add to more than the
  span starts at ``start`` and has its latest times clamped to ``end``
  (none at the cell's counts: with all 200 slots of 138,493 histories
  real, the largest G of a seed is under 0.9 of the span).

So times rise along a sequence, PAD slots hold 0, and the gaps between a
slot and the slots before it fall in the time buckets of roughly 0 to
67 (a 20-year gap falls in bucket 67), as a real rating log's would.
"""

from __future__ import annotations

import numpy as np

from benchmark.data import torch_seed

TIMES = 6  # the random stream of the times (`benchmark.data`'s streams are 0-5)


def times_for(seqs: np.ndarray, law: dict, seed: int, device="cpu") -> np.ndarray:
    """(n, N) int64 times in seconds of the left-padded (n, N) ``seqs``
    (PAD = 0) under ``law`` (the module's note), drawn from ``seed``."""
    import torch

    g = torch.Generator(device).manual_seed(torch_seed(seed, TIMES))
    real = torch.as_tensor(seqs, device=device) != 0
    n, N = real.shape

    def log_uniform(lo, hi, shape):
        u = torch.rand(shape, generator=g, device=device, dtype=torch.float64)
        return torch.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))

    u = torch.rand(n, generator=g, device=device, dtype=torch.float64)
    same = torch.rand((n, N), generator=g, device=device, dtype=torch.float64) < law["session_p"]
    gaps = torch.where(same, log_uniform(*law["in_session_s"], (n, N)),
                       log_uniform(*law["between_sessions_s"], (n, N)))
    gaps = torch.floor(gaps).long()
    first = real & ~torch.cat([torch.zeros_like(real[:, :1]), real[:, :-1]], dim=1)
    gaps = torch.cumsum(torch.where(real & ~first, gaps, 0), dim=1)
    room = (law["end"] - law["start"] - gaps[:, -1]).clamp(min=0)
    start = law["start"] + torch.floor(u * (room + 1).double()).long()
    times = (start[:, None] + gaps).clamp(max=law["end"])
    return torch.where(real, times, 0).cpu().numpy()
