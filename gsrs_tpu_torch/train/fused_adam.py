"""Fused Adam: one pass over (p, m, v, g) per parameter and step (port of
`gsrs_tpu.train.fused_adam`).

- ``backend="pallas"``: the hand-written CUDA kernel
  ``csrc/fused_adam.cu`` on a CUDA parameter (it replaces the TPU kernel
  `_fused_adam_leaf_pallas`), `_adam_math` on a CPU one;
- ``backend="jnp"``: `_adam_math` in PyTorch ops on any device.

Semantics are ``optax.adam``'s (torch.optim.Adam defaults): b1 0.9, b2
0.999, eps 1e-8, bias-corrected, moments in each parameter's dtype. The
update is in place, under ``torch.no_grad()``, and each ``.grad`` is
cleared afterwards. The step count lives on the host, so lr, c1 and c2
are computed there (in float32, as JAX computes them) and no step reads
the device. ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

LAUNCHES = {"fused_adam": 0}
_DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass
class FusedAdamState:
    count: int  # steps taken
    mu: Dict[str, torch.Tensor]  # first moments, each in its parameter's dtype
    nu: Dict[str, torch.Tensor]  # second moments


def _adam_math(p, m, v, g, lr, c1, c2, b1, b2, eps):
    """The bias-corrected Adam update as fp32 operations → (p', m', v')
    in the input dtypes. c1 = 1/(1-b1^t), c2 = 1/(1-b2^t)."""
    g32 = g.float()
    m32 = b1 * m.float() + (1.0 - b1) * g32
    v32 = b2 * v.float() + (1.0 - b2) * (g32 * g32)
    upd = (m32 * c1) / (torch.sqrt(v32 * c2) + eps)
    return (p.float() - lr * upd).to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)


def _adam_math_(p, m, v, g, lr, c1, c2, b1, b2, eps) -> None:
    """`_adam_math` written back into p, m and v."""
    for dst, src in zip((p, m, v), _adam_math(p, m, v, g, lr, c1, c2, b1, b2, eps)):
        dst.copy_(src)


def fused_adam_(p, m, v, g, lr, c1, c2, b1, b2, eps) -> None:
    """One leaf's update in place: the CUDA kernel for CUDA tensors, or
    raise; `_adam_math` for CPU tensors."""
    tensors = (("p", p), ("m", m), ("v", v), ("g", g))
    devices = {t.device for _, t in tensors}
    if len(devices) != 1:
        raise ValueError(f"p, m, v and g lie on different devices: {sorted(map(str, devices))}")
    for name, t in tensors[1:]:
        if t.shape != p.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, p {tuple(p.shape)}")
    device = devices.pop()
    if device.type == "cpu":
        _adam_math_(p, m, v, g, lr, c1, c2, b1, b2, eps)
        return
    if device.type != "cuda":
        raise ValueError(f"fused_adam_ runs on CUDA or the CPU, not {device}")
    for name, t in tensors:
        if t.dtype != p.dtype or t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16 like p, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")
    from gsrs_tpu_torch.kernels import load_library

    fn = load_library("fused_adam").gsrs_fused_adam
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_float] * 8
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    # each constant as the float32 that _adam_math's fp32 operations use
    consts = [float(np.float32(c)) for c in (lr, c1, c2, b1, 1.0 - b1, b2, 1.0 - b2, eps)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(), p.numel(), *consts,
                int(p.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"fused_adam kernel launch failed: CUDA error {rc}")
    LAUNCHES["fused_adam"] += 1


@dataclasses.dataclass
class FusedAdam:
    """Adam with a fused one-pass update. ``step`` reads each
    parameter's ``.grad`` and updates the parameter in place."""

    schedule: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    backend: str = "jnp"  # "jnp" | "pallas"

    def __post_init__(self):
        if self.backend not in ("jnp", "pallas"):
            raise ValueError(f"backend must be 'jnp' or 'pallas', got {self.backend!r}")

    def init(self, params: Dict[str, torch.Tensor]) -> FusedAdamState:
        zeros = {k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                 for k, p in params.items()}
        return FusedAdamState(0, zeros, {k: z.clone() for k, z in zeros.items()})

    def scalars(self, count: int):
        """(lr, c1, c2) of the step after ``count`` steps, in float32."""
        f32 = np.float32
        t = f32(count + 1)
        lr = f32(self.schedule(count))
        c1 = f32(1.0) / (f32(1.0) - np.power(f32(self.b1), t))
        c2 = f32(1.0) / (f32(1.0) - np.power(f32(self.b2), t))
        return float(lr), float(c1), float(c2)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.nn.Parameter], state: FusedAdamState) -> FusedAdamState:
        lr, c1, c2 = self.scalars(state.count)
        for name, p in params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            update = fused_adam_ if self.backend == "pallas" else _adam_math_
            update(p, state.mu[name], state.nu[name], g, lr, c1, c2, self.b1, self.b2, self.eps)
            p.grad = None
        return FusedAdamState(state.count + 1, state.mu, state.nu)
