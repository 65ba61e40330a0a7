"""Carry a JAX LightGCN parameter pytree across to the port.

JAX's pop-gate layers compute ``x @ W + b`` with W of shape
(fan_in, fan_out); `nn.Linear` computes ``x @ weight.T + bias`` with
weight (fan_out, fan_in), so the weights are transposed."""

from __future__ import annotations

from typing import Dict, Mapping

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


def params_from_jax(
    params: Mapping[str, np.ndarray], cfg: ModelConfig, device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    """JAX ``LightGCN.init_params``-shaped dict → a state dict for
    `gsrs_tpu_torch.models.lightgcn.LightGCN.load_state_dict`, on
    ``device`` (default ``cuda:0``)."""
    names = dict(_EMBEDDINGS, **(_POP_GATE if cfg.use_pop_gate else {}))
    if set(params) != set(names):
        raise ValueError(
            f"parameter names {sorted(params)} do not match the config's {sorted(names)}"
        )
    device = resolve_device(device)
    state = {}
    for key, value in params.items():
        name, transpose = names[key]
        a = np.asarray(value, dtype=np.float32)
        state[name] = torch.from_numpy(np.array(a.T if transpose else a, order="C")).to(device)
    d = cfg.embedding_dim
    if state["user_emb"].shape[1] != d or state["item_emb"].shape[1] != d:
        raise ValueError(f"embedding width differs from embedding_dim={d}")
    return state
