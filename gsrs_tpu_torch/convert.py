"""Carry a JAX model's parameter pytree, and its optimizer state, across
to the port.

JAX's pop-gate layers compute ``x @ W + b`` with W of shape
(fan_in, fan_out); `nn.Linear` computes ``x @ weight.T + bias`` with
weight (fan_out, fan_in), so the weights, and their Adam moments, are
transposed. NGCF's per-layer ``ngcf_{w1,w2,b1,b2}_{k}`` keep their names
and shapes: the port applies them as ``x @ W`` too."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from gsrs_tpu_torch.config import ModelConfig
from gsrs_tpu_torch.device import DeviceLike, resolve_device

# JAX name → (state_dict name, transpose)
_EMBEDDINGS = {"user_emb": ("user_emb", False), "item_emb": ("item_emb", False)}
_POP_GATE = {
    "pop_w1": ("pop_fc1.weight", True), "pop_b1": ("pop_fc1.bias", False),
    "pop_w2": ("pop_fc2.weight", True), "pop_b2": ("pop_fc2.bias", False),
    "gate_w1": ("gate_fc1.weight", True), "gate_b1": ("gate_fc1.bias", False),
    "gate_w2": ("gate_fc2.weight", True), "gate_b2": ("gate_fc2.bias", False),
}


def _names(cfg: ModelConfig) -> Dict[str, Tuple[str, bool]]:
    """JAX name → (state_dict name, transpose) of ``cfg``'s model (NGCF
    and UltraGCN run without the pop gate, whatever the config says)."""
    names = dict(_EMBEDDINGS)
    if cfg.use_pop_gate and cfg.model not in ("ngcf", "ultragcn"):
        names.update(_POP_GATE)
    if cfg.model == "ngcf":
        names.update({f"ngcf_{w}_{k}": (f"ngcf_{w}_{k}", False)
                      for k in range(cfg.num_layers) for w in ("w1", "w2", "b1", "b2")})
    return names


def _tensor(value, transpose: bool, device: torch.device) -> torch.Tensor:
    a = np.asarray(value, dtype=np.float32)
    return torch.from_numpy(np.array(a.T if transpose else a, order="C")).to(device)


def params_from_jax(
    params: Mapping[str, np.ndarray], cfg: ModelConfig, device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    """JAX ``init_params``-shaped dict of ``cfg.model`` → a state dict for
    the port's model's ``load_state_dict``, on ``device`` (default
    ``cuda:0``)."""
    names = _names(cfg)
    if set(params) != set(names):
        raise ValueError(
            f"parameter names {sorted(params)} do not match the config's {sorted(names)}"
        )
    device = resolve_device(device)
    state = {}
    for key, value in params.items():
        name, transpose = names[key]
        state[name] = _tensor(value, transpose, device)
    d = cfg.embedding_dim
    if state["user_emb"].shape[1] != d or state["item_emb"].shape[1] != d:
        raise ValueError(f"embedding width differs from embedding_dim={d}")
    return state


def _adam_moments(opt_state: Any):
    """The (count, mu, nu) of a JAX Adam state: `FusedAdamState` itself,
    or the `ScaleByAdamState` inside optax's chain tuple."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _adam_moments(part)
            if found is not None:
                return found
    return None


def opt_state_from_jax(opt_state: Any, cfg, model):
    """A JAX trainer's optimizer state → the port's, for ``model`` (whose
    parameters must already hold the matching values, e.g. from
    `params_from_jax`) under ``cfg`` (an ExperimentConfig).

    optax's ``ScaleByAdamState`` (``fused_adam="off"``) becomes the
    state of a `torch.optim.Adam` over the model's parameters (exp_avg,
    exp_avg_sq and the step count); JAX's ``FusedAdamState`` becomes the
    port's `FusedAdamState`. Moments go to the model's device."""
    from gsrs_tpu_torch.train.fused_adam import FusedAdamState
    from gsrs_tpu_torch.train.optim import ScheduledAdam, make_optimizer

    adam = _adam_moments(opt_state)
    if adam is None:
        raise ValueError(f"no Adam state (count, mu, nu) in {type(opt_state).__name__}")
    names = _names(cfg.model)
    if set(adam.mu) != set(names) or set(adam.nu) != set(names):
        raise ValueError(f"moment names {sorted(adam.mu)} do not match the config's "
                         f"{sorted(names)}")
    params = dict(model.named_parameters())
    device = model.user_emb.device
    count = int(np.asarray(adam.count))

    def moments(tree):
        out = {}
        for key, (name, transpose) in names.items():
            t = _tensor(tree[key], transpose, device)
            if t.shape != params[name].shape:
                raise ValueError(f"{key}: moment shape {tuple(t.shape)} vs parameter "
                                 f"{tuple(params[name].shape)}")
            out[name] = t.to(params[name].dtype)
        return out

    mu, nu = moments(adam.mu), moments(adam.nu)
    optimizer, _ = make_optimizer(cfg.train, 1)
    if not isinstance(optimizer, ScheduledAdam):
        return FusedAdamState(count, mu, nu)
    return _torch_adam_state(optimizer, params, count, mu, nu)


def _torch_adam_state(optimizer, params, count: int, mu, nu):
    """A fresh `AdamState` of ``optimizer`` (a `ScheduledAdam`) over
    ``params`` holding the step count and the moments by name."""
    from gsrs_tpu_torch.train.optim import AdamState

    state = optimizer.init(params)
    for name, p in params.items():
        state.optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu[name],
            "exp_avg_sq": nu[name],
        }
    return AdamState(count, state.optimizer)


def seq_params_from_jax(
    params: Mapping[str, np.ndarray], kind: str, device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    """A JAX sequential model's parameters (``init_params``-shaped, numpy
    or JAX arrays) → a state dict for the port's ``kind`` model's
    ``load_state_dict``, on ``device`` (default ``cuda:0``): the same
    names, shapes and values."""
    from gsrs_tpu_torch.models.registry import SEQ_MODELS

    if kind not in SEQ_MODELS:
        raise ValueError(f"unknown sequential model {kind!r}; available: {sorted(SEQ_MODELS)}")
    device = resolve_device(device)
    return {name: _tensor(value, False, device) for name, value in params.items()}


def seq_opt_state_from_jax(opt_state: Any, model, optimizer):
    """``optax.adam``'s state (its ``ScaleByAdamState``: count, mu, nu)
    → the port's `AdamState` of ``optimizer`` (the sequential trainer's
    `ScheduledAdam`) over ``model``'s parameters, whose values must
    already be the JAX parameters'. Moments go to the model's device."""
    adam = _adam_moments(opt_state)
    if adam is None:
        raise ValueError(f"no Adam state (count, mu, nu) in {type(opt_state).__name__}")
    params = dict(model.named_parameters())
    if set(adam.mu) != set(params) or set(adam.nu) != set(params):
        raise ValueError(f"moment names {sorted(adam.mu)} do not match the model's "
                         f"{sorted(params)}")

    def moments(tree):
        out = {}
        for name, p in params.items():
            t = _tensor(tree[name], False, p.device)
            if t.shape != p.shape:
                raise ValueError(f"{name}: moment shape {tuple(t.shape)} vs parameter "
                                 f"{tuple(p.shape)}")
            out[name] = t
        return out

    return _torch_adam_state(optimizer, params, int(np.asarray(adam.count)),
                             moments(adam.mu), moments(adam.nu))
