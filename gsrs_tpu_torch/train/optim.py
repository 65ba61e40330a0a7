"""Optimizer assembly: Adam + step-indexed MultiStepLR (port of
`gsrs_tpu.train.optim`).

The schedule is indexed by optimizer step (milestone epoch × steps per
epoch) and equals ``optax.piecewise_constant_schedule`` at every step,
float32 rounding included: the update after ``count`` steps uses
``schedule(count)``, so a boundary b scales the updates from count b on.
torch's per-epoch `MultiStepLR` does not give this, so the trainer sets
the learning rate itself before every step.

`ScheduledAdam` also takes BERT's training (the sequential trainer's
published BERT4Rec): decoupled weight decay on the parameters of two or
more dimensions (matrices and embeddings; LayerNorm parameters and
biases are not decayed), `torch.optim.AdamW` with Adam's bias
correction, and the gradient clipped to a global norm before the step
(`torch.nn.utils.clip_grad_norm_`: g · min(1, c / (‖g‖ + 1e-6))), with
`linear_warmup_decay`'s schedule. Their defaults leave the step as it
was: `torch.optim.Adam` over one group, no clipping.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from gsrs_tpu_torch.config import TrainConfig
from gsrs_tpu_torch.train.fused_adam import FusedAdam, FusedAdamState
from gsrs_tpu_torch.utils.timer import span

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


def linear_warmup_decay(lr: float, warmup_steps: int, decay_steps: int) -> Schedule:
    """BERT's schedule (``optimization.py`` of its released code): the
    update after ``count`` steps uses lr · count / warmup_steps while
    count < warmup_steps, else lr · (1 − min(count, decay_steps) /
    decay_steps) (no decay where ``decay_steps`` is 0)."""

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return lr * count / warmup_steps
        if not decay_steps:
            return lr
        return lr * (1.0 - min(count, decay_steps) / decay_steps)

    return schedule


@dataclasses.dataclass
class AdamState:
    count: int  # steps taken
    optimizer: torch.optim.Adam


@dataclasses.dataclass
class ScheduledAdam:
    """``fused_adam="off"``: `torch.optim.Adam` (betas (0.9, 0.999), eps
    1e-8) with its learning rate set from the schedule before each step;
    with ``weight_decay``, `torch.optim.AdamW` decaying the parameters of
    two or more dimensions; with ``clip_norm``, the gradient clipped to
    that global norm first (span ``train.clip``)."""

    schedule: Schedule
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = None

    def init(self, params: Dict[str, torch.nn.Parameter]) -> AdamState:
        kw = dict(lr=self.schedule(0), betas=(self.b1, self.b2), eps=self.eps)
        if not self.weight_decay:
            return AdamState(0, torch.optim.Adam(list(params.values()), **kw))
        ps = list(params.values())
        groups = [{"params": [p for p in ps if p.dim() >= 2], "weight_decay": self.weight_decay},
                  {"params": [p for p in ps if p.dim() < 2], "weight_decay": 0.0}]
        return AdamState(0, torch.optim.AdamW([g for g in groups if g["params"]], **kw))

    def step(self, params: Dict[str, torch.nn.Parameter], state: AdamState) -> AdamState:
        lr = self.schedule(state.count)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        if self.clip_norm is not None:
            with span("train.clip"):
                torch.nn.utils.clip_grad_norm_(list(params.values()), self.clip_norm)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        return AdamState(state.count + 1, state.optimizer)


@dataclasses.dataclass
class CapturableAdam(ScheduledAdam):
    """`ScheduledAdam`'s math for a step that a CUDA graph replays (the
    sequential trainer on one card): `torch.optim.Adam`/`AdamW` with
    ``capturable=True`` (their step counts and bias corrections on the
    device) and the learning rate a float32 tensor on ``device``, which
    `set_lr` writes before each step, outside any capture: a float would
    be baked into the graph. `step` clips and updates and leaves the
    gradients where they are (a replay writes them in place); the caller
    clears them before an eager step. Checkpoints keep `ScheduledAdam`'s
    form (a float learning rate, the step counts on the host), so they
    load into either."""

    device: Optional[torch.device] = None

    def init(self, params: Dict[str, torch.nn.Parameter]) -> AdamState:
        lr = torch.tensor(self.schedule(0), dtype=torch.float32, device=self.device)
        kw = dict(lr=lr, betas=(self.b1, self.b2), eps=self.eps, capturable=True)
        ps = list(params.values())
        if self.weight_decay:
            groups = [{"params": [p for p in ps if p.dim() >= 2],
                       "weight_decay": self.weight_decay},
                      {"params": [p for p in ps if p.dim() < 2], "weight_decay": 0.0}]
            opt = torch.optim.AdamW([g for g in groups if g["params"]], **kw)
        else:
            opt = torch.optim.Adam(ps, **kw)
        # the eager steps before a capture are by design: no warning that they are uncaptured
        opt._warned_capturable_if_run_uncaptured = True
        opt.register_state_dict_post_hook(_host_form)
        opt.register_load_state_dict_pre_hook(self._device_form)
        return AdamState(0, opt)

    def set_lr(self, state: AdamState) -> None:
        """Write ``schedule(state.count)`` into the learning rate."""
        lr = self.schedule(state.count)
        for group in state.optimizer.param_groups:
            group["lr"].fill_(lr)

    def step(self, params: Dict[str, torch.nn.Parameter], state: AdamState) -> AdamState:
        if self.clip_norm is not None:
            with span("train.clip"):
                torch.nn.utils.clip_grad_norm_(list(params.values()), self.clip_norm)
        state.optimizer.step()
        return AdamState(state.count + 1, state.optimizer)

    def _device_form(self, optimizer, saved: dict) -> dict:
        groups = [dict(g, capturable=True,
                       lr=torch.tensor(float(g["lr"]), dtype=torch.float32, device=self.device))
                  for g in saved["param_groups"]]
        return dict(saved, param_groups=groups)


def _host_form(optimizer, saved: dict) -> dict:
    """`CapturableAdam`'s state dict in `ScheduledAdam`'s form."""
    groups = [dict(g, capturable=False, lr=float(g["lr"])) for g in saved["param_groups"]]
    state = {k: dict(s, step=s["step"].cpu()) if "step" in s else s
             for k, s in saved["state"].items()}
    return dict(saved, state=state, param_groups=groups)


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
