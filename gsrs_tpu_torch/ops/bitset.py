"""Packed per-user membership bitsets (port of `gsrs_tpu.ops.bitset`).

On the host a bitset is a (n_users, ceil(m_items/32)) uint32 array where
bit ``i & 31`` of word ``[u, i >> 5]`` says whether item ``i`` is a
positive of user ``u``. On the device the same words are held as an
int32 view (PyTorch's uint32 has no full operator coverage): an
arithmetic right shift sign-extends, and the ``& 1`` after it removes
the extension, so every bit reads back exactly."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def bitset_words(m_items: int) -> int:
    return (m_items + 31) // 32


def build_bitset(
    users: np.ndarray,
    items: np.ndarray,
    n_users: int,
    m_items: int,
    real_m_items: Optional[int] = None,
) -> np.ndarray:
    """Host-side construction of the packed membership table (uint32).

    ``real_m_items``: when the catalog was padded, the phantom columns
    [real_m_items, m_items) are set in every row so they are masked out
    of top-k."""
    W = bitset_words(m_items)
    out = np.zeros((n_users, W), dtype=np.uint32)
    np.bitwise_or.at(
        out,
        (users.astype(np.int64), (items >> 5).astype(np.int64)),
        (np.uint32(1) << (items & 31).astype(np.uint32)),
    )
    if real_m_items is not None and real_m_items < m_items:
        cols = np.arange(real_m_items, m_items)
        words = (cols >> 5).astype(np.int64)
        bits = np.uint32(1) << (cols & 31).astype(np.uint32)
        row_mask = np.zeros(W, dtype=np.uint32)
        np.bitwise_or.at(row_mask, words, bits)
        out |= row_mask[None, :]
    return out


def bitset_to_tensor(bitset, device: torch.device) -> torch.Tensor:
    """uint32 host words (or an int32 tensor) → contiguous int32 tensor
    of the same bits on ``device``."""
    if isinstance(bitset, torch.Tensor):
        if bitset.dtype != torch.int32:
            raise TypeError(f"bitset tensor must be int32, got {bitset.dtype}")
        return bitset.to(device).contiguous()
    words = np.array(bitset, order="C")
    if words.dtype not in (np.uint32, np.int32):
        raise TypeError(f"bitset words must be uint32, got {words.dtype}")
    return torch.from_numpy(words.view(np.int32)).to(device)


def bitset_to_numpy(bitset: torch.Tensor) -> np.ndarray:
    """int32 device words → the uint32 host array `build_bitset` gives."""
    return bitset.cpu().numpy().view(np.uint32)


def bitset_lookup(bitset: torch.Tensor, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """Membership test, broadcast over matching shapes → bool."""
    words = bitset[users, items >> 5]
    return ((words >> (items & 31).to(words.dtype)) & 1).bool()


def bitset_row_mask(bitset_rows: torch.Tensor, m_items: int) -> torch.Tensor:
    """Unpack int32 bitset rows (B, W) into a dense (B, m_items) bool
    mask: column c is bit c & 31 of word c >> 5."""
    B, W = bitset_rows.shape
    shifts = torch.arange(32, dtype=bitset_rows.dtype, device=bitset_rows.device)
    bits = (bitset_rows[:, :, None] >> shifts) & 1  # (B, W, 32)
    return bits.reshape(B, W * 32)[:, :m_items].bool()


def bitset_columns(bitset: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """The int32 words of columns [lo, hi) of ``bitset`` (rows, W), as a
    bitset of their own: column lo + j becomes bit j & 31 of word j >> 5,
    and the bits past hi - lo in the last word are 0. A catalog shard
    that starts at a column not a multiple of 32 reads its mask from
    these words (the masked-scoring kernel reads bit j of its own
    catalog)."""
    W = bitset.shape[1]
    if not 0 <= lo <= hi <= 32 * W:
        raise ValueError(f"columns [{lo}, {hi}) outside the bitset's {32 * W}")
    words = bitset_words(hi - lo)
    # each output word holds the 64-bit window of two input words from bit lo & 31
    w0, s = lo >> 5, lo & 31
    u = bitset.long() & 0xFFFFFFFF
    u = torch.cat([u, u.new_zeros(u.shape[0], 1)], dim=1)
    idx = torch.arange(w0, w0 + words, device=bitset.device)
    out = ((u[:, idx] >> s) | (u[:, idx + 1] << (32 - s))) & 0xFFFFFFFF
    tail = (hi - lo) & 31
    if tail:
        out[:, -1] &= (1 << tail) - 1
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32).contiguous()
