"""Masked full-catalog scoring: the hand-written CUDA kernel
``csrc/masked_scores.cu`` and its plain PyTorch version.

Port of the TPU kernels `gsrs_tpu.ops.pallas_kernels.masked_scores_pallas`
(natural column order) and `masked_scores_bitplane_pallas` (columns
bit-plane-permuted within each ``block_m`` tile). Both are one kernel
here, with a layout flag. On the TPU only the bit-plane kernel compiled
(the natural one hit a Mosaic reshape limit); Hopper has no such limit,
so the natural layout is the port's scorer at every catalog size and the
bit-plane layout is selected only on request (`resolve_bitplane_scoring`).

Dispatch: a CUDA tensor launches the kernel or raises (wrong device,
dtype, shape or contiguity, a failed build or a refused launch); a CPU
tensor takes `masked_scores_reference`. There is no fallback from one to
the other. ``LAUNCHES`` counts the kernel's launches per layout.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gsrs_tpu_torch.ops.bitset import bitset_row_mask, bitset_words
from gsrs_tpu_torch.utils.timer import span

NEG_INF = -1e9
LAUNCHES = {"masked_scores": 0, "masked_scores_bitplane": 0}


def resolve_bitplane_scoring(mode, m_items: int) -> bool:
    """Whether to score ``m_items`` items in the bit-plane layout.
    ``mode``: bool | "auto" | "on" | "off". Only True/"on" selects it, at
    every catalog size: the JAX package's "auto" chose it on a TPU
    backend only, and on Hopper the natural layout needs no item
    permutation."""
    if mode is True or mode == "on":
        return True
    if mode is False or mode in ("off", "auto"):
        return False
    raise ValueError(f"use_pallas_scoring must be a bool, 'auto', 'on' or 'off', got {mode!r}")


def bitplane_permutation(m_pad: int, block_m: int) -> np.ndarray:
    """perm such that bit-plane output column c scores item ``perm[c]``:
    within tile j, column k·wpb + w is item j·block_m + 32·w + k."""
    wpb = block_m // 32
    c = np.arange(m_pad, dtype=np.int64)
    j, cc = c // block_m, c % block_m
    return j * block_m + (cc % wpb) * 32 + (cc // wpb)


def _check_shapes(user_emb, item_emb, bitset_rows, bitplane, block_m) -> None:
    if user_emb.dim() != 2 or item_emb.dim() != 2 or bitset_rows.dim() != 2:
        raise ValueError("user_emb, item_emb and bitset_rows must be 2-D")
    B, d = user_emb.shape
    m = item_emb.shape[0]
    if item_emb.shape[1] != d:
        raise ValueError(f"embedding widths differ: {d} vs {item_emb.shape[1]}")
    if bitset_rows.shape[0] != B:
        raise ValueError(f"bitset has {bitset_rows.shape[0]} rows for a batch of {B}")
    if bitplane:
        if block_m <= 0 or block_m % 32 or m % block_m:
            raise ValueError(
                f"bit-plane layout needs block_m a positive multiple of 32 dividing "
                f"the padded catalog; got m_pad={m}, block_m={block_m}"
            )
        if bitset_rows.shape[1] != m // 32:
            raise ValueError("bit-plane bitset width must be m_pad/32 words")
    elif bitset_rows.shape[1] != bitset_words(m):
        raise ValueError(f"bitset width must be ceil(m/32) = {bitset_words(m)} words")


def masked_scores_reference(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    bitset_rows: torch.Tensor,
    bitplane: bool = False,
    block_m: int = 4096,
) -> torch.Tensor:
    """Plain version: ``u @ it.T`` with −1e9 where the mask bit is set.
    In the bit-plane layout, column c's bit is read where the kernel
    reads it (see csrc/masked_scores.cu)."""
    _check_shapes(user_emb, item_emb, bitset_rows, bitplane, block_m)
    scores = user_emb @ item_emb.T
    m = item_emb.shape[0]
    if bitplane:
        wpb = block_m // 32
        c = torch.arange(m, device=bitset_rows.device)
        cc = c % block_m
        word = (c // block_m) * wpb + cc % wpb
        bit = (cc // wpb).to(bitset_rows.dtype)
        mask = ((bitset_rows[:, word] >> bit) & 1).bool()
    else:
        mask = bitset_row_mask(bitset_rows, m)
    return scores.masked_fill(mask, NEG_INF)


def _launch(user_emb, item_emb, bitset_rows, bitplane, block_m) -> torch.Tensor:
    for name, t, dtype in (
        ("user_emb", user_emb, torch.float32),
        ("item_emb", item_emb, torch.float32),
        ("bitset_rows", bitset_rows, torch.int32),
    ):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} for the CUDA kernel, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")
    from gsrs_tpu_torch.kernels import load_library

    lib = load_library("masked_scores")
    fn = lib.gsrs_masked_scores
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, d = user_emb.shape
    m, W = item_emb.shape[0], bitset_rows.shape[1]
    out = torch.empty((B, m), dtype=torch.float32, device=user_emb.device)
    with torch.cuda.device(user_emb.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            user_emb.data_ptr(), item_emb.data_ptr(), bitset_rows.data_ptr(), out.data_ptr(),
            B, m, d, W, int(bitplane), block_m, stream,
        )
    if rc != 0:
        raise RuntimeError(f"masked_scores kernel launch failed: CUDA error {rc}")
    LAUNCHES["masked_scores_bitplane" if bitplane else "masked_scores"] += 1
    return out


def masked_scores(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    bitset_rows: torch.Tensor,
    bitplane: bool = False,
    block_m: int = 4096,
) -> torch.Tensor:
    """Fused ``user_emb @ item_emb.T`` with train-positive masking.

    user_emb (B, d) and item_emb (m, d) fp32; bitset_rows (B, W) int32
    words. Natural layout: W = ceil(m/32), output (B, m). Bit-plane
    layout: item_emb holds the padded catalog already permuted by
    `bitplane_permutation(m_pad, block_m)`, W = m_pad/32, output
    (B, m_pad) whose column c scores item ``perm[c]``."""
    devices = {t.device for t in (user_emb, item_emb, bitset_rows)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return masked_scores_reference(user_emb, item_emb, bitset_rows, bitplane, block_m)
    if device.type != "cuda":
        raise ValueError(f"masked_scores runs on CUDA or the CPU, not {device}")
    _check_shapes(user_emb, item_emb, bitset_rows, bitplane, block_m)
    with span("k1", shape=(user_emb.shape[0], item_emb.shape[0], user_emb.shape[1],
                           bitset_rows.shape[1])):
        return _launch(user_emb, item_emb, bitset_rows, bitplane, block_m)
