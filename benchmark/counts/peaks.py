"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit). A card set below 700 W runs slower
under load: every share is stated against these peaks, with the card's
power limit beside it (`power_limit_w`)."""

from __future__ import annotations

import subprocess
from typing import Optional

HBM_BYTES_PER_S = 3.35e12
FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "float16": 989e12}


def least_s(flops: float, nbytes: float, dtype: str = "float32"):
    """(seconds, "flops" | "bytes"): the least time the card needs for
    ``flops`` operations at the ``dtype`` peak and ``nbytes`` of HBM
    traffic, and which of the two bounds it."""
    t_ops, t_bytes = flops / FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return (t_ops, "flops") if t_ops >= t_bytes else (t_bytes, "bytes")


def power_limit_w() -> Optional[float]:
    """The first card's power limit in watts by ``nvidia-smi``, or None
    where it cannot be read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
