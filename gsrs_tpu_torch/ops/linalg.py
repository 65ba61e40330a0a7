"""Small shared numeric helpers (port of `gsrs_tpu.ops.linalg`)."""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization along the last axis: x · rsqrt(max(Σx², eps))."""
    return x * torch.rsqrt(torch.clamp((x * x).sum(dim=-1, keepdim=True), min=eps))
