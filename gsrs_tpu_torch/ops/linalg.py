"""Small shared numeric helpers (port of `gsrs_tpu.ops.linalg`)."""

from __future__ import annotations

import contextlib

import torch


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization along the last axis: x · rsqrt(max(Σx², eps))."""
    return x * torch.rsqrt(torch.clamp((x * x).sum(dim=-1, keepdim=True), min=eps))


@contextlib.contextmanager
def fp32_reduction():
    """cuBLAS may add a bf16 product's split-K partials in bf16 unless
    told not to (PyTorch allows it by default); JAX's product is rounded
    to bf16 once, from an fp32 sum. The switch is process-wide, so a
    backward run inside the context is pinned too."""
    matmul = torch.backends.cuda.matmul
    allowed = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = allowed
