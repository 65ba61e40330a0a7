"""The training loop (port of `gsrs_tpu.train.trainer`).

An epoch samples its triplets on the device in chunks of at most
``steps_per_scan`` batches (128 by default), then runs one optimizer
step per batch: propagation forward and backward through the ELL
gather-reduce kernel, the BPR loss plus ``decay · reg``, and Adam
(`gsrs_tpu_torch.train.optim`). The per-step losses stay on the device;
the host reads their mean once per epoch. Parameters live in the model
and are updated in place.

`fit` runs the JAX trainer's loop: an eval before every
``eval_every``-th epoch and a final one, best-NDCG checkpoints and early
stop, the ``last`` checkpoint at its cadence, periodic legacy-named
saves, CSV and TensorBoard logs, ``model_meta.json``, resume and
``load_pretrained``. Checkpoints (`gsrs_tpu_torch.train.checkpoint`) hold
the parameters, the optimizer state (its step count with it), the epoch
and the best metric, with the tables cut to the data's real node counts
(phantom rows of a padded run dropped); restoring copies into the live
parameters.

On a ``data_axis × model_axis`` mesh (`cfg.parallel`, one process per
rank in an initialized process group) the model is sharded in place
(`gsrs_tpu_torch.parallel.sharding.GraphShardings.place_model`: table
rows over ``model``, ELL edge slots over the mesh; the tiled and hybrid
layouts' residual edge slots over the mesh and their dense hub blocks by
columns, where the JAX Trainer replicates those two layouts: the same
sums, a fraction of the blocks a rank). Every rank
samples the same global batches and steps on its data slice
(`gsrs_tpu_torch.parallel.dist_train.mesh_step`); the evaluator scores
catalog shards. Rank 0 prints, logs and writes the checkpoints, whose
tables it gathers into the single-card form; resume shards them again.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from gsrs_tpu_torch.config import ExperimentConfig
from gsrs_tpu_torch.data.adjacency import BipartiteGraph
from gsrs_tpu_torch.data.dataset import InteractionData
from gsrs_tpu_torch.device import DeviceLike, resolve_device
from gsrs_tpu_torch.ops.sampling import make_sampler_state, sample_epoch
from gsrs_tpu_torch.parallel.collectives import all_reduce_, broadcast_object
from gsrs_tpu_torch.parallel.dist_train import mesh_step
from gsrs_tpu_torch.parallel.mesh import make_mesh, single_device_mesh
from gsrs_tpu_torch.parallel.sharding import GRAPH_TABLES, GraphShardings
from gsrs_tpu_torch.train.checkpoint import CheckpointManager, legacy_name
from gsrs_tpu_torch.train.evaluator import Evaluator
from gsrs_tpu_torch.train.logging import (
    NullLog, TensorboardWriter, make_train_csv, make_valid_csv,
)
from gsrs_tpu_torch.train.optim import (
    load_optimizer_state, make_optimizer, optimizer_state_dict,
)

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
    """Trains ``model`` (a LightGCN on ``device``, default ``cuda:0``: on a
    mesh, the rank's device) on ``data``. ``graph`` is the model's
    bipartite graph (kept for parity with the JAX trainer's signature).
    A mesh larger than 1 × 1 shards ``model`` in place."""

    def __init__(
        self,
        cfg: ExperimentConfig,
        data: InteractionData,
        graph: BipartiteGraph,
        model,
        run_eval: bool = True,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if model.user_emb.device != self.device:
            raise ValueError(f"the model is on {model.user_emb.device}, the Trainer on "
                             f"{self.device}")
        par = cfg.parallel
        self.mesh = None
        if par.data_axis * par.model_axis > 1:
            self.mesh = make_mesh(par, device=self.device)
            if model.batch_separable and cfg.train.batch_size % par.data_axis:
                raise ValueError(f"batch_size {cfg.train.batch_size} must divide by the data "
                                 f"axis ({par.data_axis})")
        # the 1 x 1 mesh on one card: its layout is the identity, and the
        # checkpoint form is the same
        self._sh = GraphShardings(self.mesh or single_device_mesh(self.device))
        if self.mesh is not None:
            self._sh.place_model(model)
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
                      device=self.device, mesh=self.mesh)
            if (run_eval and data.test_dict) else None
        )
        # triplets sampled per epoch; None = train_size
        self.epoch_samples: Optional[int] = None

    # ------------------------------------------------------------------ init
    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Re-initializes the model's parameters from ``seed`` (default
        ``cfg.train.seed``) and a fresh optimizer state."""
        seed = self.cfg.train.seed if seed is None else seed
        generator = torch.Generator().manual_seed(seed)
        if self.mesh is None:
            self.model.init_params(generator)
        else:
            self._sh.init_params(self.model, generator)
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
        dropout, and is needed when the config asks for dropout. On a mesh
        every rank passes the same global batches and a generator seeded
        alike; the losses are the global ones, on every rank."""
        batches = [torch.as_tensor(b, dtype=torch.int64, device=self.device)
                   for b in (users_b, pos_b, neg_b)]
        decay = self.cfg.train.decay
        gen = dropout_generator if self._uses_dropout() else None
        if self._uses_dropout() and gen is None:
            raise ValueError("the config asks for edge dropout: pass a dropout_generator")
        opt_state = state.opt_state
        losses = []
        for users, pos, neg in zip(*batches):
            if self.mesh is not None:
                opt_state, share = mesh_step(self.model, self.optimizer, self.mesh, state.params,
                                             opt_state, users, pos, neg, decay, gen)
                losses.append(share)
                continue
            loss, aux = self.model.bpr_loss(users, pos, neg, gen)
            total = loss + decay * aux["reg"]
            total.backward()
            opt_state = self.optimizer.step(state.params, opt_state)
            losses.append(total.detach())
        losses = torch.stack(losses)
        if self.mesh is not None:
            all_reduce_(losses, self.mesh)  # the ranks' shares sum to each step's loss
        return dataclasses.replace(state, opt_state=opt_state), losses

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

    def _logged_lr(self, state: TrainState) -> float:
        """The CSVs' lr as the JAX trainer writes it: the configured value
        under a constant schedule (optax returns it as given), the float32
        value of the step-indexed one."""
        t_cfg = self.cfg.train
        if not t_cfg.use_scheduler or not t_cfg.sched_milestones:
            return t_cfg.lr
        return self.current_lr(state)

    # ------------------------------------------------------------ checkpoint
    @functools.cached_property
    def ckpt(self) -> CheckpointManager:
        """The checkpoint directory's manager, made (with the directory) at
        first use."""
        return CheckpointManager(self.cfg.train.checkpoint_dir)

    def _legacy_name(self) -> str:
        m = self.cfg.model
        return legacy_name(m.model, self.data.name, m.num_layers, m.embedding_dim)

    @property
    def primary(self) -> bool:
        """Whether this process prints, logs and writes checkpoints."""
        return self.mesh is None or self.mesh.is_primary

    def _table_rows(self, real: bool) -> Dict[str, int]:
        d = self.data
        if real:
            return {"user_emb": d.real_n_users or d.n_users,
                    "item_emb": d.real_m_items or d.m_items}
        return {"user_emb": d.n_users, "item_emb": d.m_items}

    def _ckpt_state(self, state: TrainState) -> Dict[str, Any]:
        """The checkpoint: tables (and their moments) whole and cut to the
        real node counts. On a mesh every rank calls it (it gathers)."""
        params = {k: p.detach() for k, p in state.params.items()}
        params, opt = self._sh.canonical_state(
            params, optimizer_state_dict(state.opt_state, state.params), self._table_rows(True))
        return {"params": params, "opt_state": opt, "epoch": int(state.epoch),
                "best_metric": float(state.best_metric)}

    def _restore(self, state: TrainState, saved: Dict[str, Any],
                 weights_only: bool = False) -> TrainState:
        """Copy a checkpoint's parameters into the live ones (this rank's
        rows of its tables; phantom rows keep their values); unless
        ``weights_only``, take its optimizer state, epoch and best metric."""
        if set(saved["params"]) != set(state.params):
            raise ValueError(f"the checkpoint's parameters {sorted(saved['params'])} differ "
                             f"from the model's {sorted(state.params)}")
        live = {k: state.params[k] for k in GRAPH_TABLES}
        params, opt = self._sh.local_state(saved["params"], saved["opt_state"], live,
                                           self._table_rows(False))
        saved = {**saved, "params": params, "opt_state": opt}
        with torch.no_grad():
            for name, p in state.params.items():
                src = saved["params"][name]
                if src.shape != p.shape:
                    raise ValueError(f"{name}: checkpoint {tuple(src.shape)}, model "
                                     f"{tuple(p.shape)}")
                p.copy_(src)
        if weights_only:
            return state
        return TrainState(
            params=state.params,
            opt_state=load_optimizer_state(self.optimizer, state.params, saved["opt_state"]),
            epoch=int(saved["epoch"]),
            best_metric=float(saved["best_metric"]),
        )

    def save_last(self, state: TrainState) -> None:
        ckpt = self._ckpt_state(state)
        if self.primary:
            self.ckpt.save_last(ckpt)

    def _resolve(self, resume_path: Optional[str], legacy: str) -> Optional[str]:
        """Rank 0's resolution of the resume chain (it may recover a
        checkpoint stranded mid-swap), on every rank."""
        path = None
        if self.primary:
            path = self.ckpt.resolve_resume_path(resume_path, legacy)
        return path if self.mesh is None else broadcast_object(path, self.mesh)

    def maybe_resume(self, state: TrainState) -> TrainState:
        """Restore from the resume chain (an explicit ``resume_path``, then
        ``last``, then the legacy name); ``state`` unchanged when none
        exists."""
        path = self._resolve(self.cfg.train.resume_path, self._legacy_name())
        if path is None:
            return state
        state = self._restore(state, self.ckpt.restore(path))
        if self.primary:
            print(f"[resume] restored checkpoint from {path}")
        return state

    def resume_weights(self, state: TrainState) -> TrainState:
        """The parameters, epoch and best metric of the checkpoint that
        `maybe_resume` would restore, without its optimizer state (what an
        eval or a serving artifact needs, whatever optimizer trained it:
        `maybe_resume` refuses a state of another ``fused_adam`` setting);
        ``state`` unchanged when no checkpoint exists."""
        path = self._resolve(self.cfg.train.resume_path, self._legacy_name())
        if path is None:
            return state
        saved = self.ckpt.restore(path)
        state = self._restore(state, saved, weights_only=True)
        if self.primary:
            print(f"[resume] restored the weights of {path}")
        return dataclasses.replace(state, epoch=int(saved["epoch"]),
                                   best_metric=float(saved["best_metric"]))

    # ------------------------------------------------------------------ fit
    def fit(
        self,
        state: Optional[TrainState] = None,
        epochs: Optional[int] = None,
        log_dir: Optional[str] = None,
        verbose: bool = True,
    ) -> TrainState:
        """A training run with the JAX trainer's loop: eval before every
        ``eval_every``-th epoch (epoch 0 included) and after the last one,
        best-NDCG checkpoints and early stop, ``last`` at its cadence (and
        always at the end), periodic legacy-named saves, CSV/TensorBoard
        logs. On a mesh every rank runs it; rank 0 alone prints and
        writes."""
        t_cfg = self.cfg.train
        epochs = t_cfg.epochs if epochs is None else epochs
        verbose = verbose and self.primary
        state = state or self.init_state()
        if t_cfg.load_pretrained:
            # weights only, from the legacy-named checkpoint; epoch 0 and a
            # fresh optimizer state stay; a missing one is a warning
            legacy = self._legacy_name()
            legacy_path = os.path.join(t_cfg.checkpoint_dir, legacy)
            path = (legacy_path if os.path.isdir(legacy_path)
                    else self._resolve(None, legacy))
            if path is not None:
                state = self._restore(state, self.ckpt.restore(path), weights_only=True)
                if self.primary:
                    print(f"[load] restored pretrained weights from {path}")
            elif self.primary:
                print(f"[load] WARNING: no pretrained checkpoint ({legacy})")
        if t_cfg.resume:
            state = self.maybe_resume(state)

        train_csv = valid_csv = NullLog()
        tb = TensorboardWriter(None)
        if self.primary:
            train_csv = make_train_csv(t_cfg.checkpoint_dir)
            valid_csv = make_valid_csv(t_cfg.checkpoint_dir, self.cfg.eval.topks)
            # the model config beside the checkpoints, for serve export
            with open(os.path.join(t_cfg.checkpoint_dir, "model_meta.json"), "w") as f:
                json.dump(dataclasses.asdict(self.cfg.model), f)
            tb = TensorboardWriter(log_dir if t_cfg.tensorboard else None, t_cfg.comment)
        main_k = max(self.cfg.eval.topks)
        last_eval_epoch = last_saved_epoch = -1
        evals_since_best = 0
        finished = False

        try:
            while state.epoch < epochs:
                # eval_every <= 0: no eval in the loop, the final one runs
                if (self.evaluator is not None and t_cfg.eval_every > 0
                        and state.epoch % t_cfg.eval_every == 0):
                    last_eval_epoch = state.epoch
                    state, improved = self._run_eval(state, valid_csv, tb, verbose, "eval")
                    if improved:
                        evals_since_best = 0
                    else:
                        evals_since_best += 1
                        if t_cfg.early_stop_evals and evals_since_best >= t_cfg.early_stop_evals:
                            if verbose:
                                print(f"[early-stop] no ndcg@{main_k} improvement in "
                                      f"{evals_since_best} evals (best {state.best_metric:.5f})")
                            break

                t0 = time.time()
                state, loss = self.train_epoch(state)
                dt = time.time() - t0
                train_csv.append({"epoch": state.epoch, "time_sec": f"{dt:.3f}",
                                  "train_loss": f"{loss:.6f}", "lr": self._logged_lr(state)})
                tb.scalar("Train/loss", loss, state.epoch)
                if verbose:
                    print(f"[epoch {state.epoch}/{epochs}] loss={loss:.5f} ({dt:.2f}s)")
                if t_cfg.save_last_every == 1 or state.epoch % max(1, t_cfg.save_last_every) == 0:
                    self.save_last(state)
                    last_saved_epoch = state.epoch
                if t_cfg.save_every and state.epoch % t_cfg.save_every == 0:
                    ckpt = self._ckpt_state(state)
                    if self.primary:
                        self.ckpt.save_periodic(ckpt, self._legacy_name())

            # the in-loop eval runs before an epoch, so the state after the
            # last epoch has not been evaluated
            if self.evaluator is not None and last_eval_epoch != state.epoch:
                state, _ = self._run_eval(state, valid_csv, tb, verbose, "final eval")
            finished = True
        finally:
            # leave a current 'last' behind (throttled cadence, early stop,
            # an interrupt), unless the loop just wrote it; a mesh rank
            # that failed saves nothing (the save gathers from every rank)
            if (t_cfg.checkpoint_dir and last_saved_epoch != state.epoch
                    and (finished or self.mesh is None)):
                self.save_last(state)
            tb.close()
        return state

    def _run_eval(self, state, valid_csv, tb, verbose, label="eval"):
        """One eval, its CSV row and TensorBoard scalars, and a best-NDCG
        checkpoint on improvement → (state, improved)."""
        main_k = max(self.cfg.eval.topks)
        t0 = time.time()
        metrics = self.evaluate(state)
        eval_sec = time.time() - t0
        row = {"epoch": state.epoch, "time_sec": f"{eval_sec:.3f}",
               "lr": self._logged_lr(state)}
        row.update({k: f"{v:.6f}" for k, v in metrics.items()})
        valid_csv.append(row)
        tb.eval_metrics(metrics, self.cfg.eval.topks, state.epoch)
        if verbose:
            print(f"[{label} e{state.epoch}] "
                  + " ".join(f"{k}={v:.5f}" for k, v in sorted(metrics.items())))
        ndcg = metrics.get(f"ndcg@{main_k}", 0.0)
        improved = ndcg > state.best_metric
        if improved:
            state = dataclasses.replace(state, best_metric=ndcg)
            ckpt = self._ckpt_state(state)
            if self.primary:
                self.ckpt.save_best(ckpt, state.epoch, self.cfg.train.keep_topk)
        return state, improved
