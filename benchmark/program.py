"""What the harness hands the program under test (`gsrs_tpu_torch`) and
reads back from it: its configuration objects and its dataset, built from
a configuration file and the benchmark's own arrays."""

from __future__ import annotations

import sys
import time

from benchmark.data import Interactions


def experiment_config(cfg: dict, seed: int):
    """The port's `ExperimentConfig` of the configuration's ``model``,
    ``train`` and ``eval`` sections; the run's seed drives its sampler.
    No checkpoint directory or TensorBoard log is written."""
    from gsrs_tpu_torch.config import EvalConfig, ExperimentConfig, ModelConfig, TrainConfig

    ev = dict(cfg.get("eval", {}))
    if "topks" in ev:
        ev["topks"] = tuple(ev["topks"])
    return ExperimentConfig(
        model=ModelConfig(**cfg["model"]),
        train=TrainConfig(**cfg["train"], seed=seed % 2**63, tensorboard=False),
        eval=EvalConfig(**ev),
    )


def interaction_data(name: str, x: Interactions):
    """The port's `InteractionData` over the benchmark's arrays."""
    from gsrs_tpu_torch.data.dataset import InteractionData

    return InteractionData(name=name, n_users=x.n_users, m_items=x.m_items,
                           train_users=x.train_users, train_items=x.train_items,
                           test_dict=x.test_dict())


def set_tables(model, tables) -> None:
    """Copy the benchmark's (n + m, d) tables into the model's user and
    item embeddings."""
    import torch

    n = model.user_emb.shape[0]
    with torch.no_grad():
        model.user_emb.copy_(tables[:n])
        model.item_emb.copy_(tables[n:])


def first_moments(opt_state, params: dict) -> dict:
    """Adam's first moment of each parameter, by name, from the port's
    optimizer state (`torch.optim.Adam`'s ``exp_avg`` or the fused Adam's
    ``mu``); zeros for a parameter the optimizer holds none for."""
    import torch

    if hasattr(opt_state, "mu"):
        return {k: opt_state.mu.get(k, torch.zeros_like(p)) for k, p in params.items()}
    inner = opt_state.optimizer.state
    return {k: inner.get(p, {}).get("exp_avg", torch.zeros_like(p)) for k, p in params.items()}


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Phases:
    """Seconds of each named phase of a set-up, printed on standard error:
    what the set-up is spent on."""

    def __init__(self, device):
        self.device = device
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        synchronize(self.device)
        now = time.perf_counter()
        print(f"setup {name} {now - self.t:.3f} s", file=sys.stderr, flush=True)
        self.t = now
