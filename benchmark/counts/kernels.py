"""Least time of each hand-written kernel call, from the call's own
shapes: the operations and bytes the inputs need, each input byte read
once and each output byte written once, whatever the kernel reads again.

- K1 (``masked_scores``): 2·B·m·d fp32 operations; the user rows, the
  item table and the B bitset rows read once, and k ids and k values a
  user written. The (B, m) scores matrix is not counted, so a top-k
  fused into K1 later is held to the same work.
- K4 (``ell_gather_reduce``): 8 B per slot of nonzero weight (its column
  and weight), the source rows and the output rows once; 2·nnz·d
  operations. As ``chip_smoke.py::time_ell_side`` counts it.
- K3 (``fused_adam``): p, m, v, g read and p, m, v written, 12
  operations an element. As ``chip_smoke.py::time_adam_leaves`` counts it.
"""

from __future__ import annotations

from benchmark.counts.peaks import least_s

# the device kernels' names as the profiler reports them
K1_KERNELS = ("masked_scores_kernel",)
K4_KERNELS = ("ell_gather_kernel", "ell_split_sum_kernel")
K3_KERNELS = ("fused_adam_kernel",)


def k1_least_s(B: int, m: int, d: int, W: int, k: int) -> float:
    flops = 2.0 * B * m * d
    nbytes = 4.0 * (B * d + m * d + B * W) + 8.0 * B * k
    return least_s(flops, nbytes, "float32")[0]


def k4_least_s(nnz: int, n_src: int, n_rows: int, d: int, elem: int) -> float:
    flops = 2.0 * nnz * d
    nbytes = 8.0 * nnz + elem * (n_src + n_rows) * d
    return least_s(flops, nbytes, "float32")[0]


def k3_least_s(leaves) -> float:
    """``leaves``: [(numel, element bytes)] of one launch."""
    flops = 12.0 * sum(n for n, _ in leaves)
    nbytes = 7.0 * sum(n * e for n, e in leaves)
    return least_s(flops, nbytes, "float32")[0]
