"""The training loop (port of `gsrs_tpu.train.trainer`).

An epoch samples its triplets on the device in chunks of at most
``steps_per_scan`` batches (128 by default), then runs one optimizer
step per batch: propagation forward and backward through the ELL
gather-reduce kernel, the BPR loss plus ``decay · reg``, and Adam
(`gsrs_tpu_torch.train.optim`). The per-step losses stay on the device;
the host reads their mean once per epoch. Parameters live in the model
and are updated in place.

Ported so far: `init_state`, `train_epoch`, `run_steps`, `evaluate`,
`current_lr` and ``epoch_samples`` on one device. `fit`, checkpoints and
CSV/TensorBoard logging are ROADMAP.md A4; meshes larger than 1 × 1 are
A7.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from gsrs_tpu_torch.config import ExperimentConfig
from gsrs_tpu_torch.data.adjacency import BipartiteGraph
from gsrs_tpu_torch.data.dataset import InteractionData
from gsrs_tpu_torch.device import DeviceLike, resolve_device
from gsrs_tpu_torch.ops.sampling import make_sampler_state, sample_epoch
from gsrs_tpu_torch.train.evaluator import Evaluator
from gsrs_tpu_torch.train.optim import make_optimizer

_SAMPLE, _DROPOUT = 0, 1  # the random streams of an epoch chunk


@dataclasses.dataclass
class TrainState:
    """The model's parameters (live, by their state-dict names), the
    optimizer state, the epoch count and the best eval metric."""

    params: Dict[str, torch.nn.Parameter]
    opt_state: Any
    epoch: int = 0
    best_metric: float = 0.0


def stream_seed(seed: int, epoch: int, chunk: int, stream: int) -> int:
    """A generator seed determined by (seed, epoch, chunk, stream)."""
    return int(np.random.SeedSequence([seed, epoch, chunk, stream]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


class Trainer:
    """Trains ``model`` (a LightGCN on ``device``, default ``cuda:0``) on
    ``data``. ``graph`` is the model's bipartite graph (kept for parity
    with the JAX trainer's signature)."""

    def __init__(
        self,
        cfg: ExperimentConfig,
        data: InteractionData,
        graph: BipartiteGraph,
        model,
        run_eval: bool = True,
        device: DeviceLike = None,
    ):
        par = cfg.parallel
        if par.data_axis * par.model_axis > 1:
            raise NotImplementedError(
                f"a {par.data_axis} x {par.model_axis} mesh is not ported yet "
                "(ROADMAP.md A7, parallel/); use data_axis = model_axis = 1")
        self.device = resolve_device(device)
        if model.user_emb.device != self.device:
            raise ValueError(f"the model is on {model.user_emb.device}, the Trainer on "
                             f"{self.device}")
        self.cfg = cfg
        self.data = data
        self.graph = graph
        self.model = model
        self.sampler_state = make_sampler_state(data, self.device)
        # models that mask per-user positives in their loss share the
        # sampler's bitset instead of holding a second copy
        if getattr(model, "wants_train_bitset", False):
            model.train_bitset = self.sampler_state.train_bitset
        self.steps_per_epoch = max(1, -(-data.train_size // cfg.train.batch_size))
        self.optimizer, self.schedule = make_optimizer(cfg.train, self.steps_per_epoch)
        self.evaluator = (
            Evaluator(data, model, cfg.eval, train_bitset=self.sampler_state.train_bitset,
                      device=self.device)
            if (run_eval and data.test_dict) else None
        )
        # triplets sampled per epoch; None = train_size
        self.epoch_samples: Optional[int] = None

    # ------------------------------------------------------------------ init
    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Re-initializes the model's parameters from ``seed`` (default
        ``cfg.train.seed``) and a fresh optimizer state."""
        seed = self.cfg.train.seed if seed is None else seed
        self.model.init_params(torch.Generator().manual_seed(seed))
        params = dict(self.model.named_parameters())
        return TrainState(params=params, opt_state=self.optimizer.init(params))

    # ------------------------------------------------------------ train step
    def _uses_dropout(self) -> bool:
        return self.cfg.model.dropout or getattr(self.model, "needs_step_key", False)

    def run_steps(
        self,
        state: TrainState,
        users_b,
        pos_b,
        neg_b,
        dropout_generator: Optional[torch.Generator] = None,
    ) -> Tuple[TrainState, torch.Tensor]:
        """One optimizer step per row of the (n, B) triplet batches →
        (state, the n per-step losses ``loss + decay · reg`` on the
        device). ``dropout_generator`` (on the device) drives edge
        dropout, and is needed when the config asks for dropout."""
        batches = [torch.as_tensor(b, dtype=torch.int64, device=self.device)
                   for b in (users_b, pos_b, neg_b)]
        decay = self.cfg.train.decay
        gen = dropout_generator if self._uses_dropout() else None
        if self._uses_dropout() and gen is None:
            raise ValueError("the config asks for edge dropout: pass a dropout_generator")
        opt_state = state.opt_state
        losses = []
        for users, pos, neg in zip(*batches):
            loss, aux = self.model.bpr_loss(users, pos, neg, gen)
            total = loss + decay * aux["reg"]
            total.backward()
            opt_state = self.optimizer.step(state.params, opt_state)
            losses.append(total.detach())
        return dataclasses.replace(state, opt_state=opt_state), torch.stack(losses)

    def train_epoch(self, state: TrainState) -> Tuple[TrainState, float]:
        """One epoch: ``epoch_samples`` (default train_size) triplets,
        rounded up to full batches, sampled on the device chunk by chunk,
        each chunk's steps run at once → (state, mean step loss)."""
        t_cfg = self.cfg.train
        B = t_cfg.batch_size
        epoch_size = self.epoch_samples or self.data.train_size
        num_batches = max(1, -(-epoch_size // B))
        spc = t_cfg.steps_per_scan or min(num_batches, 128)
        if spc == -1:
            spc = num_batches
        if spc < 1:
            raise ValueError(f"steps_per_scan must be >= -1, got {t_cfg.steps_per_scan}")
        by_edge = getattr(self.model, "samples_pairs_by_edge", False)
        losses = []
        for chunk_i, c0 in enumerate(range(0, num_batches, spc)):
            n = min(spc, num_batches - c0)
            g = torch.Generator(self.device).manual_seed(
                stream_seed(t_cfg.seed, state.epoch, chunk_i, _SAMPLE))
            users_b, pos_b, neg_b = sample_epoch(g, self.sampler_state, n * B, B,
                                                 by_edge=by_edge,
                                                 neg_candidates=t_cfg.neg_candidates)
            drop = torch.Generator(self.device).manual_seed(
                stream_seed(t_cfg.seed, state.epoch, chunk_i, _DROPOUT))
            state, chunk_losses = self.run_steps(state, users_b, pos_b, neg_b, drop)
            losses.append(chunk_losses)
        mean = float(torch.cat(losses).mean())
        return dataclasses.replace(state, epoch=state.epoch + 1), mean

    # ------------------------------------------------------------------ eval
    def evaluate(self, state: TrainState) -> Dict[str, float]:
        """Metrics of the model's current parameters (``state.params``
        are those parameters)."""
        if self.evaluator is None:
            raise ValueError("the dataset has no test split, or the Trainer was built "
                             "with run_eval=False")
        return self.evaluator.run()

    def current_lr(self, state: TrainState) -> float:
        return float(self.schedule(state.epoch * self.steps_per_epoch))
