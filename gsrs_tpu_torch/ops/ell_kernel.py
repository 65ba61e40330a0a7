"""ELL gather-reduce: the hand-written CUDA kernel
``csrc/ell_gather_reduce.cu`` and its plain PyTorch version.

Port of the TPU kernel `tools/probe_pallas_gather.py` (a DMA row gather
with a block reduction) as the gather-reduce of each ELL bucket in
`gsrs_tpu.ops.ell._apply_side`: ``out[n] = Σ_j w[n, j] · x[cols[n, j]]``,
with ``w[n, j] · mask[eidx[n, j]]`` in place of the weight when an edge
mask is given (cast to x's dtype before the product, as JAX's einsum
does). `BucketTable` holds the buckets of one side, checked once;
`gather_reduce` writes every bucket's rows into one output buffer, one
after the other, in one call of the kernel's entry point on the card.

On the card the work is a list built once per side (`build_work_list`):
each row stops at its real length (trailing padding is skipped), a row
longer than ``split`` real slots is cut into chunks of ``split`` slots
whose fp32 partial sums a second kernel adds in chunk order, so a side
with split rows issues two kernels per call.

Dispatch: CUDA tensors launch the kernel or raise (wrong device, dtype,
shape or contiguity, a failed build or a refused launch); CPU tensors take
`gather_reduce_reference` bucket by bucket. There is no fallback from one
to the other. ``LAUNCHES`` counts the calls of the kernel's entry point,
and each `BucketTable` counts those made for its own side.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

LAUNCHES = {"ell_gather_reduce": 0}
MAX_BUCKETS = 64  # kMaxBuckets of the CUDA source: buckets per launch
SPLIT_SLOTS = 256  # S: the most real slots one warp sums
_DTYPES = (torch.float32, torch.bfloat16)


class _Bucket(ctypes.Structure):
    _fields_ = [
        ("cols", ctypes.c_void_p), ("w", ctypes.c_void_p), ("eidx", ctypes.c_void_p),
        ("width", ctypes.c_int32), ("out_row0", ctypes.c_int32),
    ]


class _Table(ctypes.Structure):
    _fields_ = [("b", _Bucket * MAX_BUCKETS), ("n_buckets", ctypes.c_int32)]


def gather_reduce_reference(
    cols: torch.Tensor,
    w: torch.Tensor,
    x: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    eidx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version for one bucket → (n_b, d) in x's dtype: the
    `index_select` + `einsum` of `gsrs_tpu.ops.ell._apply_side`, with
    the masked weights cast to x's dtype as there."""
    if mask is not None:
        w = w * mask[eidx]
    d = x.shape[-1]
    gathered = x.index_select(0, cols.reshape(-1)).reshape(*cols.shape, d)
    return torch.einsum("nd,ndk->nk", w.to(x.dtype), gathered)


class WorkList(NamedTuple):
    """The kernel's work over the buckets of one launch table (see
    csrc/ell_gather_reduce.cu), longest items first.

    ``items`` (n_items, 4) int32 rows ``(b | n << 8, row, j0, part)``:
    slots [j0, j0 + n) of row ``row`` of bucket ``b``; ``part`` is −1 for
    a whole row, stored to its output row, else the scratch row that takes
    the chunk's fp32 partial sum. ``splits`` (n_split, 4) int32 rows
    ``(out_row, part0, n_parts, 0)``: a split row's output is the sum of
    scratch rows part0 … part0 + n_parts − 1, in that order. ``n_parts``:
    the scratch rows needed."""

    items: torch.Tensor
    splits: torch.Tensor
    n_parts: int


def real_lengths(w: torch.Tensor) -> torch.Tensor:
    """(n_b,) int64: each row's real length, the slot after its last
    non-zero weight (0 for a row of padding only)."""
    if w.numel() == 0:
        return torch.zeros(w.shape[0], dtype=torch.int64, device=w.device)
    slot = torch.arange(1, w.shape[1] + 1, device=w.device)
    return torch.where(w != 0, slot, 0).amax(dim=1)


def build_work_list(
    buckets: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    split: int = SPLIT_SLOTS,
    row0: int = 0,
) -> WorkList:
    """The work list of up to MAX_BUCKETS buckets ``(cols, w, eidx)``
    whose rows are output rows ``row0, row0 + 1, …``: a row of real
    length L ≤ ``split`` is one item; a longer one is ceil(L/split) chunk
    items of ``split`` slots (the last one shorter) and one split row.
    Plain torch on the buckets' device."""
    if split <= 0 or split % 32 or split >= 2**23:
        raise ValueError(f"split must be a positive multiple of 32 below 2**23, got {split}")
    if len(buckets) > MAX_BUCKETS:
        raise ValueError(f"a launch table holds at most {MAX_BUCKETS} buckets")
    device = buckets[0][1].device if buckets else torch.device("cpu")

    def stack4(*fields):  # four fields (tensors, or scalars broadcast) → (n, 4)
        return torch.stack([torch.as_tensor(f, device=device).expand_as(fields[0])
                            for f in fields], 1)

    items, splits, n_parts = [], [], 0
    for b, (_, w, _) in enumerate(buckets):
        length = real_lengths(w)
        rows = torch.arange(w.shape[0], device=device)
        whole = length <= split
        items.append(stack4(b + (length[whole] << 8), rows[whole], 0, -1))
        long_rows, long_len = rows[~whole], length[~whole]
        if long_rows.numel():
            k = (long_len + split - 1) // split
            first = torch.cumsum(k, 0) - k  # each split row's first chunk
            n_chunks = int(k.sum())
            j0 = (torch.arange(n_chunks, device=device)
                  - torch.repeat_interleave(first, k)) * split
            n = torch.minimum(torch.repeat_interleave(long_len, k) - j0,
                              torch.tensor(split, device=device))
            items.append(stack4(b + (n << 8), torch.repeat_interleave(long_rows, k), j0,
                               n_parts + torch.arange(n_chunks, device=device)))
            splits.append(stack4(row0 + long_rows, n_parts + first, k, 0))
            n_parts += n_chunks
        row0 += w.shape[0]
    if n_parts >= 2**31 or row0 >= 2**31:
        raise ValueError("the work list indexes rows and partial sums with int32")
    items = torch.cat(items) if items else torch.zeros(0, 4, dtype=torch.int64, device=device)
    order = torch.sort(items[:, 0] >> 8, descending=True, stable=True).indices
    splits = torch.cat(splits) if splits else torch.zeros(0, 4, dtype=torch.int64, device=device)
    return WorkList(items[order].to(torch.int32).contiguous(),
                    splits.to(torch.int32).contiguous(), n_parts)


class BucketTable:
    """The buckets of one ELL side, ``(cols, w, eidx)`` each with cols
    and eidx (n_b, W_b) int32 and w (n_b, W_b) fp32, all on one device.
    Their outputs stack in this order into rows [0, n_rows) of the
    output. Shapes, dtypes and index ranges are checked here, once; on
    the card the launch tables and their work lists (rows split at
    ``split`` real slots) are built here too."""

    def __init__(self, buckets: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
                 split: int = SPLIT_SLOTS):
        self.buckets = tuple(buckets)
        self.split = split
        devices = {t.device for b in self.buckets for t in b}
        if len(devices) > 1:
            raise ValueError(f"buckets lie on different devices: {sorted(map(str, devices))}")
        self.device = devices.pop() if devices else torch.device("cpu")
        self.max_col = self.max_eidx = -1
        self.n_rows = 0
        for cols, w, eidx in self.buckets:
            if cols.dim() != 2 or w.shape != cols.shape or eidx.shape != cols.shape:
                raise ValueError("a bucket's cols, w and eidx must share one (n_b, W) shape")
            if cols.dtype != torch.int32 or eidx.dtype != torch.int32 or w.dtype != torch.float32:
                raise TypeError("a bucket's cols and eidx must be int32 and its w float32")
            if cols.numel():
                self.max_col = max(self.max_col, int(cols.max()))
                self.max_eidx = max(self.max_eidx, int(eidx.max()))
            self.n_rows += cols.shape[0]
        if self.n_rows >= 2**31 or max((c.numel() for c, _, _ in self.buckets), default=0) >= 2**31:
            raise ValueError("the kernel indexes rows and slots of a bucket with int32")
        self._tables = self._launch_tables() if self.device.type == "cuda" else ()
        self._scratch = {}
        self.launches = 0  # this table's kernel launches (one of LAUNCHES' count)

    def _launch_tables(self):
        tables, row0 = [], 0
        for start in range(0, len(self.buckets), MAX_BUCKETS):
            table = _Table()
            chunk = self.buckets[start:start + MAX_BUCKETS]
            work = build_work_list(chunk, self.split, row0)
            for slot, (cols, w, eidx) in zip(table.b, chunk):
                for t in (cols, w, eidx):
                    if not t.is_contiguous():
                        raise ValueError("bucket tensors must be contiguous for the CUDA kernel")
                slot.cols, slot.w, slot.eidx = cols.data_ptr(), w.data_ptr(), eidx.data_ptr()
                slot.width, slot.out_row0 = cols.shape[1], row0
                row0 += cols.shape[0]
            table.n_buckets = len(chunk)
            tables.append((table, work))
        return tuple(tables)

    def scratch(self, d: int) -> Optional[torch.Tensor]:
        """The fp32 (n_parts, d) buffer of the split rows' partial sums,
        allocated at first use for each d and shared by this side's calls
        (they run in stream order); None when no row is split."""
        n_parts = max((work.n_parts for _, work in self._tables), default=0)
        if n_parts == 0:
            return None
        if d not in self._scratch:
            self._scratch[d] = torch.empty(n_parts, d, dtype=torch.float32, device=self.device)
        return self._scratch[d]


def _check_inputs(table: BucketTable, x, mask, out) -> None:
    for name, t in (("x", x), ("mask", mask), ("out", out)):
        if t is not None and t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, the buckets on {table.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (S, d), got shape {tuple(x.shape)}")
    if x.shape[0] <= table.max_col:
        raise ValueError(f"x has {x.shape[0]} rows; the buckets reach row {table.max_col}")
    if mask is not None and (mask.dim() != 1 or mask.shape[0] <= table.max_eidx):
        raise ValueError(f"mask must be 1-D with more than {table.max_eidx} entries")
    if out.dim() != 2 or out.shape[0] < table.n_rows or out.shape[1] != x.shape[1]:
        raise ValueError(f"out must be ({table.n_rows}+, {x.shape[1]}), got {tuple(out.shape)}")
    if out.dtype != x.dtype:
        raise TypeError(f"out is {out.dtype}, x is {x.dtype}")


def _launch(table: BucketTable, x, mask, out) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16 for the CUDA kernel, got {x.dtype}")
    if mask is not None and mask.dtype != torch.float32:
        raise TypeError(f"mask must be float32 for the CUDA kernel, got {mask.dtype}")
    for name, t in (("x", x), ("mask", mask), ("out", out)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")
    from gsrs_tpu_torch.kernels import load_library

    fn = load_library("ell_gather_reduce").gsrs_ell_gather_reduce
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, i, p, p, p, p, i, i, p]
    fn.restype = ctypes.c_int
    mask_ptr = None if mask is None else mask.data_ptr()
    scratch = table.scratch(x.shape[1])
    scratch_ptr = None if scratch is None else scratch.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for t, work in table._tables:
            rc = fn(ctypes.addressof(t), work.items.data_ptr(), work.items.shape[0],
                    work.splits.data_ptr(), work.splits.shape[0], scratch_ptr, x.data_ptr(),
                    mask_ptr, out.data_ptr(), x.shape[1], int(x.dtype == torch.bfloat16), stream)
            if rc != 0:
                raise RuntimeError(f"ell_gather_reduce kernel launch failed: CUDA error {rc}")
            LAUNCHES["ell_gather_reduce"] += 1
            table.launches += 1


def gather_reduce(
    table: BucketTable,
    x: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Every bucket's ``Σ_j w · x[cols]`` into consecutive rows of
    ``out`` ((≥ table.n_rows, d) in x's dtype; allocated when None) →
    out. x is (S, d) fp32 or bf16; ``mask`` (E,) fp32 scales each slot's
    weight by ``mask[eidx]``. Rows of ``out`` past table.n_rows are left
    as they are."""
    if out is None:
        out = torch.empty(table.n_rows, x.shape[-1], dtype=x.dtype, device=x.device)
    _check_inputs(table, x, mask, out)
    if table.device.type == "cpu":
        row0 = 0
        for cols, w, eidx in table.buckets:
            n_b = cols.shape[0]
            out[row0:row0 + n_b] = gather_reduce_reference(cols, w, x, mask, eidx)
            row0 += n_b
        return out
    if table.device.type != "cuda":
        raise ValueError(f"gather_reduce runs on CUDA or the CPU, not {table.device}")
    _launch(table, x, mask, out)
    return out
