"""Fused Adam: one pass over (p, m, v, g) per parameter and step (port of
`gsrs_tpu.train.fused_adam`).

- ``backend="pallas"``: the hand-written CUDA kernel
  ``csrc/fused_adam.cu`` (it replaces the TPU kernel
  `_fused_adam_leaf_pallas`), one launch over every leaf of a step (at
  most `MAX_LEAVES` a launch), on CUDA parameters; `_adam_math` leaf by
  leaf on CPU ones;
- ``backend="jnp"``: `_adam_math` in PyTorch ops on any device.

Semantics are ``optax.adam``'s (torch.optim.Adam defaults): b1 0.9, b2
0.999, eps 1e-8, bias-corrected, moments in each parameter's dtype. The
update is in place, under ``torch.no_grad()``, and each ``.grad`` is
cleared afterwards; a ``.grad`` of None is a zero gradient. The step
count lives on the host, so lr, c1 and c2 are computed there (in float32,
as JAX computes them) and no step reads the device. ``LAUNCHES`` counts
the kernel's launches.

On the card the leaves go to the kernel as a table (`LeafPlan`): the
parameters' and moments' pointers, sizes, dtypes, 16-byte alignment and
each leaf's first chunk, built once per optimizer state and kept on it;
each step fills in only the gradient pointers.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

LAUNCHES = {"fused_adam": 0}
MAX_LEAVES = 64  # kMaxLeaves of the CUDA source: leaves a launch
CHUNK = 2048  # kChunk of the CUDA source: elements a block takes at a time
BF16, ALIGNED = 1, 2  # the table's flag bits (kBf16, kAligned)
_DTYPES = (torch.float32, torch.bfloat16)


class _Leaf(ctypes.Structure):
    _fields_ = [
        ("p", ctypes.c_void_p), ("m", ctypes.c_void_p), ("v", ctypes.c_void_p),
        ("g", ctypes.c_void_p), ("n", ctypes.c_longlong), ("chunk0", ctypes.c_int32),
        ("flags", ctypes.c_int32),
    ]


class _Table(ctypes.Structure):
    _fields_ = [("leaf", _Leaf * MAX_LEAVES), ("n_chunks", ctypes.c_int32)]


@dataclasses.dataclass
class FusedAdamState:
    count: int  # steps taken
    mu: Dict[str, torch.Tensor]  # first moments, each in its parameter's dtype
    nu: Dict[str, torch.Tensor]  # second moments
    # the kernel's leaf tables over these moments, built at the first step on the card
    plan: Optional["LeafPlan"] = dataclasses.field(default=None, repr=False, compare=False)


def _adam_math(p, m, v, g, lr, c1, c2, b1, b2, eps):
    """The bias-corrected Adam update as fp32 operations → (p', m', v')
    in the input dtypes. c1 = 1/(1-b1^t), c2 = 1/(1-b2^t)."""
    g32 = g.float()
    m32 = b1 * m.float() + (1.0 - b1) * g32
    v32 = b2 * v.float() + (1.0 - b2) * (g32 * g32)
    upd = (m32 * c1) / (torch.sqrt(v32 * c2) + eps)
    return (p.float() - lr * upd).to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)


def _adam_math_(p, m, v, g, lr, c1, c2, b1, b2, eps) -> None:
    """`_adam_math` written back into p, m and v; a ``g`` of None is a
    zero gradient (a 0-d zero, broadcast: the same bits)."""
    if g is None:
        g = p.new_zeros(())
    for dst, src in zip((p, m, v), _adam_math(p, m, v, g, lr, c1, c2, b1, b2, eps)):
        dst.copy_(src)


def _consts(b1, b2, eps) -> Tuple[float, ...]:
    """b1, 1 - b1, b2, 1 - b2, eps as the kernel takes them: ctypes
    rounds each to the float32 that `_adam_math`'s fp32 operations use,
    as it rounds lr, c1 and c2."""
    return (b1, 1.0 - b1, b2, 1.0 - b2, eps)


_FN = None
_FN_LOCK = threading.Lock()


def _kernel_fn():
    """The kernel's C entry, built and bound once."""
    global _FN
    if _FN is None:
        with _FN_LOCK:
            if _FN is None:
                from gsrs_tpu_torch.kernels import load_library

                fn = load_library("fused_adam").gsrs_fused_adam_leaves
                fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_float] * 8
                               + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
                _FN = fn
    return _FN


def _check_leaf(p, m, v) -> None:
    for name, t in (("m", m), ("v", v)):
        if t.device != p.device:
            raise ValueError(f"p and {name} lie on different devices: {p.device}, {t.device}")
        if t.shape != p.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, p {tuple(p.shape)}")
    for name, t in (("p", p), ("m", m), ("v", v)):
        if t.dtype != p.dtype or t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16 like p, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")


class LeafPlan:
    """The kernel's leaf tables over a list of (p, m, v) leaves: for each
    launch of at most `MAX_LEAVES` leaves, a `_Table` holding each
    leaf's pointers, size, dtype flag, alignment flag (p, m and v at
    16-byte boundaries; a gradient that is not clears it for its step)
    and first chunk, leaves in order, each cut into chunks of `CHUNK`
    elements. Checks every leaf once (one device, p's dtype fp32 or bf16
    and m, v alike, the same shapes, contiguous) and raises on what the
    kernel does not take. `fill` sets a step's gradient pointers."""

    def __init__(self, leaves: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]):
        devices = {p.device for p, _, _ in leaves}
        if len(devices) > 1:
            raise ValueError(f"the leaves lie on different devices: {sorted(map(str, devices))}")
        for p, m, v in leaves:
            _check_leaf(p, m, v)
        self.device = devices.pop() if devices else None
        self.p_ptrs = [p.data_ptr() for p, _, _ in leaves]
        self.moments = [(m, v) for _, m, v in leaves]  # held: their pointers are in the tables
        self.shapes = [tuple(p.shape) for p, _, _ in leaves]
        self.dtypes = [p.dtype for p, _, _ in leaves]
        self.tables: List[Tuple[_Table, int]] = []  # (table, its leaves' count)
        self._entries: List[_Leaf] = []  # every leaf's table entry, in leaf order
        self._flags: List[int] = []  # each leaf's flags before its gradient is known
        for start in range(0, len(leaves), MAX_LEAVES):
            table, n_chunks = _Table(), 0
            part = leaves[start:start + MAX_LEAVES]
            for i, (p, m, v) in enumerate(part):
                e = table.leaf[i]
                e.p, e.m, e.v, e.g = p.data_ptr(), m.data_ptr(), v.data_ptr(), None
                e.n, e.chunk0 = p.numel(), n_chunks
                aligned = all(t.data_ptr() % 16 == 0 for t in (p, m, v))
                e.flags = (BF16 if p.dtype == torch.bfloat16 else 0) | (ALIGNED if aligned else 0)
                n_chunks += -(-e.n // CHUNK)
                self._entries.append(e)
                self._flags.append(e.flags)
            table.n_chunks = n_chunks
            self.tables.append((table, len(part)))

    def matches(self, params: Sequence[torch.Tensor], mu: Sequence[torch.Tensor],
                nu: Sequence[torch.Tensor]) -> bool:
        """Whether the tables still point at these parameters, of the
        shapes and dtypes they were built for, and at these moments."""
        return (len(params) == len(self.p_ptrs)
                and all(p.data_ptr() == ptr and p.shape == s and p.dtype == dt
                        for p, ptr, s, dt in zip(params, self.p_ptrs, self.shapes, self.dtypes))
                and all(m is mm and v is vv for m, v, (mm, vv) in zip(mu, nu, self.moments)))

    def fill(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        """Each leaf's gradient pointer for this step (null for None),
        after checking it as its leaf was checked; an unaligned gradient
        sends its leaf down the scalar path."""
        if len(grads) != len(self._entries):
            raise ValueError(f"{len(grads)} gradients for {len(self._entries)} leaves")
        for i, (g, e) in enumerate(zip(grads, self._entries)):
            if g is None:
                e.g, e.flags = None, self._flags[i]
                continue
            if g.device != self.device:
                raise ValueError(f"gradient {i} lies on {g.device}, its leaf on {self.device}")
            if g.dtype != self.dtypes[i]:
                raise TypeError(f"gradient {i} must be {self.dtypes[i]} like its leaf, got "
                                f"{g.dtype}")
            if g.shape != self.shapes[i]:
                raise ValueError(f"gradient {i} has shape {tuple(g.shape)}, its leaf "
                                 f"{self.shapes[i]}")
            if not g.is_contiguous():
                raise ValueError(f"gradient {i} must be contiguous for the CUDA kernel")
            ptr = g.data_ptr()
            e.g, e.flags = ptr, self._flags[i] & ~ALIGNED if ptr % 16 else self._flags[i]

    def launch(self, grads: Sequence[Optional[torch.Tensor]], lr, c1, c2,
               consts: Tuple[float, ...]) -> None:
        """One kernel launch per table on the current stream of the
        leaves' card, ``consts`` from `_consts`; raises off the card."""
        if self.device is None or self.device.type != "cuda":
            raise ValueError(f"the CUDA kernel runs on CUDA tensors, not {self.device}")
        self.fill(grads)
        fn = _kernel_fn()
        if torch.cuda.current_device() == self.device.index:
            self._launch(fn, lr, c1, c2, consts)
        else:
            with torch.cuda.device(self.device):
                self._launch(fn, lr, c1, c2, consts)

    def _launch(self, fn, lr, c1, c2, consts) -> None:
        stream = torch.cuda.current_stream().cuda_stream
        for table, n_leaves in self.tables:
            if table.n_chunks == 0:
                continue
            rc = fn(ctypes.addressof(table), n_leaves, lr, c1, c2, *consts, stream)
            if rc != 0:
                raise RuntimeError(f"fused_adam kernel launch failed: CUDA error {rc}")
            LAUNCHES["fused_adam"] += 1


def fused_adam_leaves_(leaves: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                              Optional[torch.Tensor]]],
                       lr, c1, c2, b1, b2, eps) -> None:
    """Every leaf's update in place, from a list of (p, m, v, g or None):
    one kernel launch per `MAX_LEAVES` leaves for CUDA tensors, or raise;
    `_adam_math` leaf by leaf for CPU tensors."""
    devices = {t.device for leaf in leaves for t in leaf if t is not None}
    if len(devices) > 1:
        raise ValueError(f"the leaves lie on different devices: {sorted(map(str, devices))}")
    if not devices:
        return
    device = devices.pop()
    if device.type == "cpu":
        for p, m, v, g in leaves:
            for name, t in (("m", m), ("v", v), ("g", g)):
                if t is not None and t.shape != p.shape:
                    raise ValueError(f"{name} has shape {tuple(t.shape)}, p {tuple(p.shape)}")
            _adam_math_(p, m, v, g, lr, c1, c2, b1, b2, eps)
        return
    if device.type != "cuda":
        raise ValueError(f"fused_adam runs on CUDA or the CPU, not {device}")
    plan = LeafPlan([(p, m, v) for p, m, v, _ in leaves])
    plan.launch([g for *_, g in leaves], lr, c1, c2, _consts(b1, b2, eps))


def fused_adam_(p, m, v, g, lr, c1, c2, b1, b2, eps) -> None:
    """One leaf's update in place: `fused_adam_leaves_` of one leaf."""
    fused_adam_leaves_([(p, m, v, g)], lr, c1, c2, b1, b2, eps)


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
        self._consts = _consts(self.b1, self.b2, self.eps)

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

    def plan(self, params: Dict[str, torch.Tensor], state: FusedAdamState) -> LeafPlan:
        """``state``'s leaf tables over ``params``: its own while they
        still point at these tensors, else new ones."""
        ps = list(params.values())
        mu, nu = [state.mu[k] for k in params], [state.nu[k] for k in params]
        if state.plan is not None and state.plan.matches(ps, mu, nu):
            return state.plan
        return LeafPlan(list(zip(ps, mu, nu)))

    @torch.no_grad()
    def step(self, params: Dict[str, torch.nn.Parameter], state: FusedAdamState) -> FusedAdamState:
        lr, c1, c2 = self.scalars(state.count)
        plan = state.plan
        if self.backend == "pallas" and any(p.is_cuda for p in params.values()):
            plan = self.plan(params, state)
            plan.launch([p.grad for p in params.values()], lr, c1, c2, self._consts)
        else:
            for name, p in params.items():
                _adam_math_(p, state.mu[name], state.nu[name], p.grad, lr, c1, c2, self.b1,
                            self.b2, self.eps)
        for p in params.values():
            p.grad = None
        return FusedAdamState(state.count + 1, state.mu, state.nu, plan)
