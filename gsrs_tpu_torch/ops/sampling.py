"""BPR triplet sampling on the device (port of `gsrs_tpu.ops.sampling`).

Triplets (user, positive, negative): users uniform over the users that
have a positive, positives uniform over the user's positives, negatives
uniform over the catalog minus the user's positives. The device sampler
draws ``neg_candidates`` candidates per triplet and keeps the first that
the packed train bitset says is not a positive: shape-static and free of
host round trips. Random numbers come from a `torch.Generator` on the
device, so the streams differ from JAX's for the same seed; the tests
hold both packages to the same contract instead. `sample_triplets_python`
is the numpy fallback, identical to the JAX package's, and
`sample_triplets_host` the host dispatch between it and the native C++
sampler (`gsrs_tpu_torch.native`)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from gsrs_tpu_torch.data.dataset import InteractionData
from gsrs_tpu_torch.device import DeviceLike, resolve_device
from gsrs_tpu_torch.ops.bitset import bitset_lookup, bitset_to_tensor, build_bitset

# With C uniform candidates the chance that all hit the user's positives
# is (deg_u/m)^C: ~1e-12 at Gowalla-like density for C=4; C=16 keeps the
# worst realistic user (deg/m ≈ 0.25) below 1e-9.
NEG_CANDIDATES = 16
_INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class SamplerState:
    """Device-resident structures for on-device triplet sampling. Index
    arrays are int64 on the device (torch indexes with int64)."""

    pos_indptr: torch.Tensor  # (n_users+1,) CSR offsets into pos_items
    pos_items: torch.Tensor  # (N,) concatenated per-user positives
    valid_users: torch.Tensor  # (n_valid_pad,) users with ≥1 positive
    train_bitset: torch.Tensor  # (n_users, W) int32 view of the packed positives
    n_valid: int
    m_items: int


def make_sampler_state(data: InteractionData, device: DeviceLike = None) -> SamplerState:
    """Sampler state on ``device`` (default ``cuda:0``). valid_users is
    padded to a power of two by repeating its content, as in JAX."""
    device = resolve_device(device)
    net = data.user_item_net
    valid = np.flatnonzero(data.user_degrees > 0)
    n_valid = int(valid.size)
    pad = max(1, 1 << (n_valid - 1).bit_length()) if n_valid else 1
    bitset = build_bitset(data.train_users, data.train_items, data.n_users, data.m_items,
                          real_m_items=data.real_m_items)

    def t(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)

    return SamplerState(
        pos_indptr=t(net.indptr),
        pos_items=t(net.indices),
        valid_users=t(np.resize(valid, pad)),
        train_bitset=bitset_to_tensor(bitset, device),
        n_valid=n_valid,
        m_items=data.m_items,
    )


def sample_triplets(
    generator: torch.Generator,
    state: SamplerState,
    num_samples: int,
    neg_candidates: int = NEG_CANDIDATES,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Draw ``num_samples`` (user, pos, neg) int64 triplets on the
    generator's device. If all ``neg_candidates`` candidates are
    positives, the first is taken (the ρ^C bias floor of the JAX
    sampler). ``neg_candidates=0`` is the UNCHECKED mode: one uniform
    draw and no bitset test."""
    dev = state.pos_items.device
    u_idx = torch.randint(0, state.n_valid, (num_samples,), generator=generator, device=dev)
    users = state.valid_users[u_idx]
    start = state.pos_indptr[users]
    degree = state.pos_indptr[users + 1] - start
    pos_off = torch.randint(0, _INT32_MAX, (num_samples,), generator=generator, device=dev)
    positives = state.pos_items[start + pos_off % degree]
    if neg_candidates == 0:
        negatives = torch.randint(0, state.m_items, (num_samples,), generator=generator,
                                  device=dev)
        return users, positives, negatives
    cands = torch.randint(0, state.m_items, (num_samples, neg_candidates),
                          generator=generator, device=dev)
    is_pos = bitset_lookup(state.train_bitset, users[:, None], cands)
    # argmax takes the first maximal index; it needs an integer tensor
    first_ok = torch.argmax((~is_pos).to(torch.int32), dim=1)
    negatives = cands.gather(1, first_ok[:, None])[:, 0]
    return users, positives, negatives


def sample_pairs_by_edge(
    generator: torch.Generator, state: SamplerState, num_samples: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(user, pos) pairs uniform over interactions (edges): an edge index,
    then its user by a binary search over the CSR offsets."""
    dev = state.pos_items.device
    e = torch.randint(0, state.pos_items.shape[0], (num_samples,), generator=generator,
                      device=dev)
    users = torch.searchsorted(state.pos_indptr, e, right=True) - 1
    return users, state.pos_items[e]


def sample_epoch(
    generator: torch.Generator,
    state: SamplerState,
    epoch_size: int,
    batch_size: int,
    by_edge: bool = False,
    neg_candidates: int = NEG_CANDIDATES,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """An epoch of triplets rounded up to full batches, each (num_batches,
    batch_size). ``by_edge`` draws (user, pos) uniformly over edges and
    repeats the positive in the negative slot."""
    num_batches = -(-epoch_size // batch_size)
    total = num_batches * batch_size
    if by_edge:
        u, p = sample_pairs_by_edge(generator, state, total)
        n = p
    else:
        u, p, n = sample_triplets(generator, state, total, neg_candidates)
    shape = (num_batches, batch_size)
    return u.reshape(shape), p.reshape(shape), n.reshape(shape)


def sample_triplets_python(
    rng: np.random.Generator, data: InteractionData, num_samples: int
) -> np.ndarray:
    """Numpy fallback: an (S, 3) int64 array of [user, pos, neg] rows.
    Users without positives, or whose positives cover the real catalog,
    are skipped (so S ≤ num_samples); negatives are drawn over the real
    catalog only."""
    users = rng.integers(0, data.n_users, num_samples)
    rows = []
    net = data.user_item_net
    real_m = data.real_m_items or data.m_items
    for u in users:
        s, e = net.indptr[u], net.indptr[u + 1]
        if s == e or e - s >= real_m:
            continue
        pos = net.indices[s + rng.integers(0, e - s)]
        while True:
            neg = int(rng.integers(0, real_m))
            if not np.any(net.indices[s:e] == neg):
                break
        rows.append((u, pos, neg))
    return np.asarray(rows, dtype=np.int64).reshape(-1, 3)


def sample_triplets_host(
    data: InteractionData, num_samples: int, seed: int = 2020
) -> np.ndarray:
    """Host-side sampling with the reference's dispatch: the native C++
    sampler when the host compiler built it, else `sample_triplets_python`
    → (S, 3) int64 rows [user, pos, neg]. The native path is the
    reference C++'s round robin over the users, the Python path its
    uniform users."""
    from gsrs_tpu_torch.native import load_native_sampler

    native = load_native_sampler()
    if native is not None:
        native.seed(seed)
        net = data.user_item_net
        # real catalog only: padded phantom ids are not valid negatives
        return native.sample_negative(data.n_users, data.real_m_items or data.m_items,
                                      num_samples, net.indptr, net.indices, neg_num=1)
    return sample_triplets_python(np.random.default_rng(seed), data, num_samples)
