"""Optimizer assembly: Adam + step-indexed MultiStepLR (port of
`gsrs_tpu.train.optim`).

The schedule is indexed by optimizer step (milestone epoch × steps per
epoch) and equals ``optax.piecewise_constant_schedule`` at every step,
float32 rounding included: the update after ``count`` steps uses
``schedule(count)``, so a boundary b scales the updates from count b on.
torch's per-epoch `MultiStepLR` does not give this, so the trainer sets
the learning rate itself before every step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch

from gsrs_tpu_torch.config import TrainConfig
from gsrs_tpu_torch.train.fused_adam import FusedAdam, FusedAdamState

Schedule = Callable[[int], float]


def lr_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Schedule:
    """count → learning rate (a Python float holding a float32 value)."""
    lr = np.float32(cfg.lr)
    if not cfg.use_scheduler or not cfg.sched_milestones:
        return lambda count: float(lr)
    boundaries = sorted({int(m) * steps_per_epoch: cfg.sched_gamma
                         for m in cfg.sched_milestones}.items())

    def schedule(count: int) -> float:
        v = lr
        for threshold, scale in boundaries:
            if count >= threshold:
                v = np.float32(np.float32(scale) * v)
        return float(v)

    return schedule


@dataclasses.dataclass
class AdamState:
    count: int  # steps taken
    optimizer: torch.optim.Adam


@dataclasses.dataclass
class ScheduledAdam:
    """``fused_adam="off"``: `torch.optim.Adam` (betas (0.9, 0.999), eps
    1e-8) with its learning rate set from the schedule before each step."""

    schedule: Schedule
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Dict[str, torch.nn.Parameter]) -> AdamState:
        opt = torch.optim.Adam(list(params.values()), lr=self.schedule(0),
                               betas=(self.b1, self.b2), eps=self.eps)
        return AdamState(0, opt)

    def step(self, params: Dict[str, torch.nn.Parameter], state: AdamState) -> AdamState:
        lr = self.schedule(state.count)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        return AdamState(state.count + 1, state.optimizer)


Optimizer = Union[ScheduledAdam, FusedAdam]


def optimizer_state_dict(state, params: Dict[str, torch.nn.Parameter]) -> dict:
    """The optimizer state as plain values and tensors, for a checkpoint:
    the step count, and `torch.optim.Adam.state_dict()` (each
    parameter's ``step`` and moments, by position in ``params``) or the
    fused moments in the order of ``params``."""
    if isinstance(state, FusedAdamState):
        names = list(params)
        return {"kind": "fused_adam", "count": int(state.count), "names": names,
                "mu": [state.mu[n] for n in names], "nu": [state.nu[n] for n in names]}
    return {"kind": "adam", "count": int(state.count), "torch": state.optimizer.state_dict()}


def load_optimizer_state(optimizer: Optimizer, params: Dict[str, torch.nn.Parameter],
                         saved: dict):
    """A fresh state of ``optimizer`` over ``params`` holding ``saved``
    (`optimizer_state_dict`'s), mapped back by the order of ``params``;
    moments go to each parameter's device and dtype."""
    fused = isinstance(optimizer, FusedAdam)
    if saved["kind"] != ("fused_adam" if fused else "adam"):
        raise ValueError(f"the checkpoint holds a {saved['kind']} state, the run's optimizer "
                         f"is {type(optimizer).__name__}: use the same fused_adam setting")
    state = optimizer.init(params)
    if not fused:
        state.optimizer.load_state_dict(saved["torch"])
        return AdamState(int(saved["count"]), state.optimizer)
    if list(saved["names"]) != list(params):
        raise ValueError(f"the checkpoint's parameters {saved['names']} differ from the "
                         f"model's {list(params)}")
    moments = []
    for tensors in (saved["mu"], saved["nu"]):
        out = {}
        for (name, p), t in zip(params.items(), tensors):
            if t.shape != p.shape:
                raise ValueError(f"{name}: saved moment {tuple(t.shape)}, parameter "
                                 f"{tuple(p.shape)}")
            out[name] = t.to(device=p.device, dtype=p.dtype).contiguous()
        moments.append(out)
    return FusedAdamState(int(saved["count"]), *moments)


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int) -> Tuple[Optimizer, Schedule]:
    """→ (optimizer, schedule). ``cfg.fused_adam``: "off" (torch Adam),
    "jnp" (fused update in PyTorch ops) or "pallas" (the CUDA kernel)."""
    sched = lr_schedule(cfg, steps_per_epoch)
    if cfg.fused_adam == "off":
        return ScheduledAdam(sched), sched
    if cfg.fused_adam in ("jnp", "pallas"):
        return FusedAdam(schedule=sched, backend=cfg.fused_adam), sched
    raise ValueError(f"fused_adam must be 'off', 'jnp' or 'pallas', got {cfg.fused_adam!r}")
