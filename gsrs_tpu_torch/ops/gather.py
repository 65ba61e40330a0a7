"""Row gathers from a 2-D table, ``table[ids]``, whose backward on the
card is a hand-written CUDA kernel (``csrc/gather_rows_grad.cu``).

The forward is the gather as before (``table[ids]``), so its values and
time do not change. The backward, the dense table gradient (each row the
sum of the gradient rows of its id's positions), is a segment sum over
the stably sorted ids: long runs of one id (BERT4Rec's PAD and MASK rows,
a skewed batch's hot items) are cut into chunks of 32 rows summed in
parallel and combined in a fixed order, with no floating-point atomics,
so two calls give the same bits, and no host read. PyTorch's own
backward of ``table[ids]`` (``index_put_`` with accumulation) sums each
id's run serially in one warp.

The kernel's one weakness: one warp a table row combines that row's chunk
partials, so a run of millions of one id (a run's chunks number its
length over 32) sets the backward's time. Callers rely on working round
it: HSTU (`models.hstu.spread_ids`) spreads the ids whose gradient is 0
over the table's rows, where its bias and head would otherwise hand the
kernel runs of millions; BERT4Rec's PAD run (about 27,700 ids a batch) is
left as it is. A combine of a long run's partials by many warps would
make that workaround needless.

Dispatch: a CPU table takes the plain version, which is ``table[ids]``
itself and its autograd backward (`gather_rows_grad_plain` computes that
backward alone). A CUDA table that needs a gradient takes the kernel or
raises: fp32 or bf16 tables of at most 2^31 − 1 rows, int32 or int64 ids;
an id outside [0, rows) fails the kernel's device-side assert (the
forward gather asserts above the table, and wraps negative ids). There is
no fallback from one to the other. ``LAUNCHES`` counts the kernel's calls
(``gather_rows_grad``, one a backward) and the plain backward's calls on
a CUDA tensor (``gather_rows_grad_plain``: timing and checks only; no
path of the port makes them).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

__all__ = ["gather_rows", "gather_rows_cat", "gather_rows_grad", "gather_rows_grad_plain",
           "LAUNCHES"]

LAUNCHES = {"gather_rows_grad": 0, "gather_rows_grad_plain": 0}
_DTYPES = (torch.float32, torch.bfloat16)
_ID_DTYPES = (torch.int32, torch.int64)
_INT32_MAX = 2**31 - 1


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for a 2-D ``table`` and integer ``ids`` of any
    shape → (*ids.shape, d); its gradient with respect to ``table`` by the
    kernel on the card (the module's note)."""
    if not (table.is_cuda and torch.is_grad_enabled() and table.requires_grad):
        return table[ids]
    _check_table(table, ids)
    return _GatherRows.apply(table, ids)


def gather_rows_cat(table: torch.Tensor, *ids: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(table[ids[0]], table[ids[1]], ...) for ids of one shape but the
    first dimension. On the card one gather of their concatenation (along
    dimension 0), so the table's gradient is one sort and one launch; on
    the CPU one gather each, as before (the same bits)."""
    if not (table.is_cuda and torch.is_grad_enabled() and table.requires_grad):
        return tuple(table[i] for i in ids)
    return gather_rows(table, torch.cat(ids)).split([i.shape[0] for i in ids])


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return table[ids]

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return gather_rows_grad(grad, ids, ctx.rows), None


def _check_table(table: torch.Tensor, ids: torch.Tensor) -> None:
    if table.dim() != 2 or table.dtype not in _DTYPES or not 1 <= table.shape[0] <= _INT32_MAX:
        raise ValueError(f"gather_rows takes a 2-D fp32 or bf16 table of 1 to 2^31 - 1 rows on "
                         f"the card, got {tuple(table.shape)} {table.dtype}")
    if ids.dtype not in _ID_DTYPES or ids.device != table.device:
        raise ValueError(f"gather_rows takes int32 or int64 ids on the table's device "
                         f"{table.device}, got {ids.dtype} on {ids.device}")


def gather_rows_grad_plain(grad: torch.Tensor, ids: torch.Tensor, rows: int) -> torch.Tensor:
    """The kernel's plain version: the gradient of ``table[ids]`` with
    respect to a table of ``rows`` rows, as autograd computes it
    (``index_put_`` with accumulation into zeros)."""
    d = grad.shape[-1]
    if grad.is_cuda:
        LAUNCHES["gather_rows_grad_plain"] += 1
    out = torch.zeros((rows, d), dtype=grad.dtype, device=grad.device)
    return out.index_put_((ids.reshape(-1),), grad.reshape(-1, d), accumulate=True)


@functools.lru_cache(maxsize=None)
def _library():
    from gsrs_tpu_torch.kernels import load_library

    lib = load_library("gather_rows_grad")
    lib.gsrs_gather_rows_grad.argtypes = (
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 2)
    lib.gsrs_gather_rows_grad.restype = ctypes.c_int
    lib.gsrs_gather_rows_grad_scratch.argtypes = [ctypes.c_int] * 3
    lib.gsrs_gather_rows_grad_scratch.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=64)
def _scratch_bytes(n: int, d: int, rows: int, device: int) -> int:
    """The entry point's scratch bytes on the current device (``device``,
    so that each card's sort plan is kept apart)."""
    return _library().gsrs_gather_rows_grad_scratch(n, d, rows)


def gather_rows_grad(grad: torch.Tensor, ids: torch.Tensor, rows: int) -> torch.Tensor:
    """The gradient of ``table[ids]`` with respect to a CUDA table of
    ``rows`` rows, by the kernel: ``grad`` (*ids.shape, d) in the table's
    dtype, any strides → (rows, d) contiguous, in that dtype. One call of
    the kernel's entry point, which sorts the ids itself (cub's radix
    sort) into one scratch buffer. Raises on what the kernel does not take
    and on a refused launch; reads nothing on the host."""
    d = grad.shape[-1]
    n = ids.numel()
    if not (grad.is_cuda and ids.device == grad.device):
        raise ValueError(f"gather_rows_grad runs on the card: grad on {grad.device}, ids on "
                         f"{ids.device}")
    if grad.dtype not in _DTYPES or ids.dtype not in _ID_DTYPES:
        raise ValueError(f"gather_rows_grad takes an fp32 or bf16 grad and int32 or int64 ids, "
                         f"got {grad.dtype} and {ids.dtype}")
    if grad.shape != (*ids.shape, d) or d < 1 or not 1 <= rows <= _INT32_MAX \
            or n > _INT32_MAX:
        raise ValueError(f"gather_rows_grad: grad {tuple(grad.shape)} for ids "
                         f"{tuple(ids.shape)} into {rows} rows")
    flat = ids.reshape(-1)
    g = grad.reshape(n, d)
    dev = grad.device
    out = torch.empty((rows, d), dtype=grad.dtype, device=dev)
    with torch.cuda.device(dev):
        nbytes = _scratch_bytes(n, d, rows, dev.index)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        rc = _library().gsrs_gather_rows_grad(
            g.data_ptr(), g.stride(0), g.stride(1), grad.dtype == torch.bfloat16,
            flat.data_ptr(), flat.dtype == torch.int64, n, d, rows, scratch.data_ptr(), nbytes,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather_rows_grad kernel launch failed: CUDA error {rc}")
    LAUNCHES["gather_rows_grad"] += 1
    return out
