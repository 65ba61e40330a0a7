"""Trainer and evaluator of the sequential family (port of
`gsrs_tpu.train.seq_trainer`).

Training: the epoch's sequences, padded to a whole number of batches with
all-PAD rows, in one permutation a epoch; per step the shifted input, the
next item as the positive, a uniform negative over the real ids (0 where
the positive is PAD), the model's dropout masks (and BERT4Rec's cloze
corruption), the loss plus ``decay · reg``, and Adam at a constant
learning rate (`train.optim.ScheduledAdam`, as ``optax.adam(lr)``); or,
with ``warmup_steps``/``decay_steps``, ``weight_decay`` and
``clip_norm``, BERT's schedule (linear warm-up, then linear decay to 0),
decoupled weight decay on the matrices and embeddings, and the gradient
clipped to a global norm (BERT4Rec's published training). The draws of a
step are made apart from the loss (`SeqTrainer.draw_step`) from a
`torch.Generator` seeded from (seed, epoch, step), the permutation's
from (seed, epoch): a run resumed at epoch e equals one that never
stopped, bit for bit, and tests can hand the port JAX's draws
(`run_steps`). Parameters live in the model and are updated in place.
A `train_epoch` call trains the rest of the epoch, or, with
``steps_per_call`` set, exactly that many steps, going on where the last
call stopped in the epoch's permutation and into the next epoch's.

A model with ``uses_times`` (HSTU) trains on a dataset with times: each
batch's (B, L) times, laid out like its ids, go with it into the step,
shifted as the input is (the input's times and the targets' times), and
into a captured step's inputs; its negatives are the model's own draw
(`draw_negatives`: HSTU's K a slot). A model without times copies
nothing new. ``HEAD_ROWS`` (`head_row_counts`) sums the slots whose
negatives a sampled-softmax head computed, counted as they are drawn, so
replayed steps count too.

On one card (a CUDA device, no mesh) a step is replayed from a CUDA
graph (`torch.cuda.CUDAGraph`): the first `WARMUP_STEPS` steps of an
optimizer state with a batch shape run eagerly (they make AdamW's state
and cuBLAS's handles and workspaces), the next is captured, the input
shift, forward, backward, clip and update, and every later step of that
shape copies its batch and draws (made eagerly, as everywhere) into the
graph's inputs and replays it. The optimizer is then `CapturableAdam`,
the same AdamW with its learning rate a device tensor written before
every step, in eager steps too, so replayed and eager steps give the
same bits. A new optimizer state (`init_state`, `restore`) warms up and
captures anew. ``STEP_GRAPHS`` counts the captures and the replays (a
captured step, run by launching its graph, counts as the capture), and a
replay adds its capture's kernel launches to `kernels.launch_counts`.
The CPU and a mesh step eagerly with `ScheduledAdam`.

Spans (`gsrs_tpu_torch.utils.timer.span`, recorded under a profile):
``train.call`` a call (``shape`` (steps, B, L)), ``train.step`` a step,
holding ``train.sample`` (the draws; HSTU's ``hstu.negatives`` inside),
``train.forward`` (the model's own spans inside: BERT4Rec's published
loss records ``seq.encode`` and ``seq.head``, ``shape`` (slots, m, d);
HSTU's `models.hstu`'s), ``train.backward`` and
``train.optimizer`` (``train.clip`` inside, where the gradient is
clipped), or on one card, after the warm-up, ``train.capture`` around
those (once; `torch.cuda.graph` synchronizes the card as it begins) or
``train.replay`` around the copies and the replay; ``sync.train.loss``
around the one read of the call's mean loss. A step reads nothing on the
host.

Eval (leave-last-item-out; HR@k is recall@k with one ground-truth item):
per padded batch of ``eval_batch`` users, the model's query, then the
whole catalog scored with the history masked by the CUDA kernel of
`gsrs_tpu_torch.ops.scoring` (K1) on the real item rows, the exact top
``max(topks)`` and the metrics summed on the device; the host reads the
sums once. `fit` is the JAX trainer's loop: an eval before every
``eval_every``-th epoch and a final one, best-NDCG checkpoints, ``last``
every epoch, CSV and TensorBoard logs, ``model_meta.json`` and resume.

On a mesh (``mesh``, a `gsrs_tpu_torch.parallel.mesh.Mesh`) the item
table is padded to the model axis's multiple and row-sharded
(`gsrs_tpu_torch.parallel.seq_sharding.SeqShardings`); every rank draws
the same global batch and draws and steps on its data slice, its loss
share weighted by its slice's part of the global normalisers; eval
scores catalog shards through K1 and merges them over the model axis.
Checkpoints hold the canonical, unpadded table, written by rank 0.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gsrs_tpu_torch.data.sequences import SequenceData
from gsrs_tpu_torch.device import DeviceLike, resolve_device
from gsrs_tpu_torch.kernels import add_launches, launch_counts, launches_since
from gsrs_tpu_torch.models.hstu import HEAD_ROWS
from gsrs_tpu_torch.ops.bitset import bitset_to_tensor, build_bitset
from gsrs_tpu_torch.ops.linalg import fp32_reduction
from gsrs_tpu_torch.ops.metrics import batch_metrics, topk_labels
from gsrs_tpu_torch.ops.scoring import masked_scores
from gsrs_tpu_torch.ops.topk import topk_scores
from gsrs_tpu_torch.parallel.collectives import (
    all_reduce_, broadcast_object, sum_replicated_grads,
)
from gsrs_tpu_torch.parallel.mesh import single_device_mesh
from gsrs_tpu_torch.parallel.seq_sharding import SEQ_TABLES, SeqShardings, slice_rows
from gsrs_tpu_torch.train.optim import (
    CapturableAdam, ScheduledAdam, linear_warmup_decay, load_optimizer_state,
    optimizer_state_dict,
)
from gsrs_tpu_torch.train.trainer import stream_seed
from gsrs_tpu_torch.utils.timer import span

_PERM, _STEP = 0, 1  # the random streams of an epoch
WARMUP_STEPS = 3  # eager steps before a capture, as PyTorch's whole-network example takes
STEP_GRAPHS = {"captures": 0, "replays": 0}


def step_graph_counts() -> Dict[str, int]:
    """The captures and replays of training steps so far (module note)."""
    return dict(STEP_GRAPHS)


def head_row_counts() -> Dict[str, int]:
    """The slots a sampled-softmax head computed so far (module note)."""
    return dict(HEAD_ROWS)


@dataclasses.dataclass
class SeqTrainState:
    """The model's parameters (live, by the JAX package's names), the
    optimizer state, the epoch count and the next step of the epoch."""

    params: Dict[str, torch.nn.Parameter]
    opt_state: Any
    epoch: int = 0
    step: int = 0


class StepDraws(NamedTuple):
    """One step's draws: the negatives ((B, L), or HSTU's (B, L, K)) and
    the model's own (`model.draw`: dropout keep masks, BERT4Rec's
    `ClozeDraws` or HSTU's `HSTUDraws`)."""

    neg: torch.Tensor
    model: Any


def _map_tensors(fn, tree: Any) -> Any:
    """``tree`` (tensors in tuples, named tuples, lists; None) with ``fn``
    of every tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        items = [_map_tensors(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if isinstance(tree, list):
        return [_map_tensors(fn, v) for v in tree]
    return tree


def _shifted(x: torch.Tensor) -> torch.Tensor:
    """(B, L) ``x`` one slot to the right, 0 in the first: the input of a
    step whose targets are ``x``."""
    out = torch.zeros_like(x)
    out[:, 1:] = x[:, :-1]
    return out


def to_device(tree: Any, device: torch.device) -> Any:
    """``tree`` with every tensor on ``device``."""
    return _map_tensors(lambda t: t.to(device), tree)


def _copy_into(dst: Any, src: Any) -> None:
    """Copy the tensors of ``src`` into those of ``dst``, a tree of the
    same form."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src, strict=True):
            _copy_into(d, s)


class _StepGraph:
    """One training step captured as a CUDA graph: its inputs (the batch
    and the draws), its loss and its optimizer state live at fixed
    addresses, and the batch's times where it has them; the kernel
    launches its capture counted."""

    def __init__(self, seqs: torch.Tensor, draws: "StepDraws",
                 times: Optional[torch.Tensor] = None):
        self.seqs, self.draws = seqs.clone(), _map_tensors(torch.clone, draws)
        self.times = None if times is None else times.clone()
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, step, state: "SeqTrainState"):
        """Capture ``step(state, seqs, draws, times)`` on the graph's
        inputs, then run it once by a replay (a capture runs nothing) →
        (state, loss)."""
        before = launch_counts()
        with torch.cuda.graph(self.graph):
            state, self.loss = step(state, self.seqs, self.draws, self.times)
        self.launches = launches_since(before)
        self.graph.replay()
        return state, self.loss.clone()

    def replay(self, seqs: torch.Tensor, draws: "StepDraws",
               times: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The step on ``seqs``, ``draws`` and ``times`` → its loss (a
        copy)."""
        self.seqs.copy_(seqs)
        _copy_into(self.draws, draws)
        if self.times is not None:
            self.times.copy_(times)
        self.graph.replay()
        add_launches(self.launches)
        return self.loss.clone()


def _catalog_bitset(users: np.ndarray, shifted_items: np.ndarray, n_users: int,
                    m_items: int, device: torch.device) -> torch.Tensor:
    """The (n_users, W) int32 bitset of shifted ids, unshifted to real ids."""
    return bitset_to_tensor(build_bitset(users.astype(np.int64),
                                         shifted_items.astype(np.int64) - 1, n_users, m_items),
                            device)


class SeqTrainer:
    """Trains ``model`` (SASRec, GRU4Rec, BERT4Rec or HSTU on ``device``,
    default ``cuda:0``: on a mesh, the rank's device) on ``data``.
    ``mesh`` shards ``model`` in place; batch_size and eval_batch must
    divide by its data axis. ``warmup_steps``, ``decay_steps``,
    ``weight_decay``, ``clip_norm``, ``adam_eps`` and ``adam_betas`` set
    the optimizer (module note); their defaults give Adam at the constant
    ``lr``."""

    def __init__(
        self,
        model,
        data: SequenceData,
        batch_size: int = 128,
        lr: float = 1e-3,
        decay: float = 0.0,
        seed: int = 2020,
        topks: Tuple[int, ...] = (10, 20),
        eval_batch: int = 256,
        mesh: Optional[Any] = None,
        device: DeviceLike = None,
        warmup_steps: int = 0,
        decay_steps: int = 0,
        weight_decay: float = 0.0,
        clip_norm: Optional[float] = None,
        adam_eps: float = 1e-8,
        adam_betas: Tuple[float, float] = (0.9, 0.999),
    ):
        self.device = dev = resolve_device(device)
        if model.item_emb.device != dev:
            raise ValueError(f"the model is on {model.item_emb.device}, the trainer on {dev}")
        if mesh is not None and getattr(model.cfg, "published", 0):
            raise ValueError("the published cloze's softmax over the catalog is not sharded: "
                             "train it on one device")
        self.uses_times = bool(getattr(model, "uses_times", False))
        if self.uses_times and mesh is not None:
            raise ValueError(f"{type(model).__name__} is not sharded: train it on one device")
        if self.uses_times and (data.train_times is None or data.eval_times is None):
            raise ValueError(f"{type(model).__name__} needs each slot's time: the dataset "
                             f"{data.name!r} has none")
        if mesh is not None and (batch_size % mesh.data_size or eval_batch % mesh.data_size):
            raise ValueError(f"batch_size {batch_size} and eval_batch {eval_batch} must divide "
                             f"by the data axis ({mesh.data_size})")
        self.mesh = mesh
        # the 1 x 1 mesh on one card: the checkpoint form is the same
        self._sh = SeqShardings(mesh or single_device_mesh(dev))
        self._canonical_rows = int(model.item_emb.shape[0])
        if mesh is not None:
            self._sh.place_model(model)
        self.model = model
        self.data = data
        self.batch_size = batch_size
        self.decay = decay
        self.seed = seed
        self.topks = tuple(topks)
        self.eval_batch = eval_batch
        if warmup_steps or decay_steps:
            schedule = linear_warmup_decay(lr, warmup_steps, decay_steps)
        else:
            schedule = lambda count: float(np.float32(lr))  # noqa: E731
        opt_kw = dict(b1=adam_betas[0], b2=adam_betas[1], eps=adam_eps,
                      weight_decay=weight_decay, clip_norm=clip_norm)
        # one card: steps replay from CUDA graphs (module note)
        self._one_card = dev.type == "cuda" and mesh is None
        self.optimizer = (CapturableAdam(schedule, device=dev, **opt_kw) if self._one_card
                          else ScheduledAdam(schedule, **opt_kw))
        # the optimizer whose steps the graphs and warm-up counts below hold
        self._graphed_opt: Optional[torch.optim.Optimizer] = None
        self._graphs: Dict[Tuple[int, ...], _StepGraph] = {}
        self._eager: Dict[Tuple[int, ...], int] = {}
        # steps a `train_epoch` call runs at most; None: the rest of the epoch
        self.steps_per_call: Optional[int] = None
        self._perm: Optional[Tuple[int, torch.Tensor]] = None

        L = data.max_len
        n = len(data.train_seqs)
        self.n_train = n
        pad = -(-n // batch_size) * batch_size
        seqs = np.zeros((pad, L), np.int64)
        seqs[:n] = data.train_seqs
        self.train_seqs = torch.from_numpy(seqs).to(dev)
        self.steps_per_epoch = pad // batch_size
        self.train_times = None  # (pad, L) int64 seconds, for a model with times
        if self.uses_times:
            times = np.zeros((pad, L), np.int64)
            times[:n] = data.train_times
            self.train_times = torch.from_numpy(times).to(dev)

        hist_u = [np.full(len(v), u, np.int64) for u, v in data.user_hist_sets.items()]
        hist_i = [np.asarray(v, np.int64) for v in data.user_hist_sets.values()]
        cat = (lambda xs: np.concatenate(xs) if xs else np.zeros(0, np.int64))
        self.hist_bitset = _catalog_bitset(cat(hist_u), cat(hist_i), data.n_users,
                                           data.m_items, dev)
        self.target_bitset = _catalog_bitset(data.eval_users, data.eval_targets, data.n_users,
                                             data.m_items, dev)

        self.n_eval = n_eval = len(data.eval_users)
        B = eval_batch
        n_b = -(-n_eval // B)
        e_seqs = np.zeros((n_b * B, L), np.int64)
        e_seqs[:n_eval] = data.eval_seqs
        users = np.zeros(n_b * B, np.int64)
        users[:n_eval] = data.eval_users
        weights = np.zeros(n_b * B, np.float32)
        weights[:n_eval] = 1.0
        self._eval_seqs = torch.from_numpy(e_seqs.reshape(n_b, B, L)).to(dev)
        self._eval_users = torch.from_numpy(users.reshape(n_b, B)).to(dev)
        self._eval_weights = torch.from_numpy(weights.reshape(n_b, B)).to(dev)
        self._eval_times = None
        if self.uses_times:
            e_times = np.zeros((n_b * B, L), np.int64)
            e_times[:n_eval] = data.eval_times
            self._eval_times = torch.from_numpy(e_times.reshape(n_b, B, L)).to(dev)
        if mesh is not None:
            from gsrs_tpu_torch.ops.bitset import bitset_columns
            from gsrs_tpu_torch.parallel.sharding import catalog_range

            self._lo, self._hi = catalog_range(data.m_items, mesh)
            self._hist_shard = bitset_columns(self.hist_bitset, self._lo, self._hi)

    # ------------------------------------------------------------------ init
    def init_state(self) -> SeqTrainState:
        """The model's parameters drawn again from ``seed``, and a fresh
        optimizer state."""
        generator = torch.Generator().manual_seed(self.seed)
        if self.mesh is None:
            self.model.init_params(generator)
        else:
            self._sh.init_params(self.model, generator, self._canonical_rows)
        params = dict(self.model.named_parameters())
        return SeqTrainState(params, self.optimizer.init(params))

    # ----------------------------------------------------------------- train
    def draw_step(self, seqs: torch.Tensor, generator: torch.Generator) -> StepDraws:
        """One step's draws for the (B, L) batch ``seqs``, on the
        generator's device: negatives uniform in [1, m] (0 where the
        positive is PAD; the model's own `draw_negatives` where it has
        one), then the model's."""
        pos = seqs.to(generator.device)
        if hasattr(self.model, "draw_negatives"):
            neg = self.model.draw_negatives(generator, pos)
        else:
            neg = torch.randint(1, self.data.m_items + 1, seqs.shape, generator=generator,
                                device=generator.device)
            neg = torch.where(pos == 0, 0, neg)
        return StepDraws(neg, self.model.draw(generator, pos))

    def _step(self, state: SeqTrainState, seqs: torch.Tensor, draws: StepDraws,
              times: Optional[torch.Tensor] = None):
        """One step → (state, the loss; on a mesh this rank's share);
        ``times``: the batch's (B, L) times, for a model with times."""
        inp = _shifted(seqs)
        draws = to_device(draws, self.device)
        kw = {} if times is None else {"times": (_shifted(times), times)}
        with fp32_reduction():  # the backward's bf16 products too
            with span("train.forward"):
                if self.mesh is None:
                    loss, aux = self.model.next_item_bpr_loss(inp, seqs, draws.neg, draws.model,
                                                              **kw)
                    total = loss + self.decay * aux["reg"]
                else:
                    total = self._mesh_share(inp, seqs, draws)
            with span("train.backward"):
                total.backward()
                if self.mesh is not None:
                    sum_replicated_grads(
                        [p for k, p in state.params.items() if k not in SEQ_TABLES], self.mesh)
        with span("train.optimizer"):
            opt_state = self.optimizer.step(state.params, state.opt_state)
        return dataclasses.replace(state, opt_state=opt_state), total.detach()

    def _captures(self) -> bool:
        """Whether steps on this trainer are captured and replayed."""
        return self._one_card

    def _train_step(self, state: SeqTrainState, seqs: torch.Tensor, draws: StepDraws,
                    times: Optional[torch.Tensor] = None):
        """One step → (state, the loss): on the CPU or a mesh `_step`; on
        one card eager for the first `WARMUP_STEPS` of the optimizer state
        and the batch shape, captured at the next, replayed after (module
        note)."""
        if not self._one_card:
            return self._step(state, seqs, draws, times)
        opt = state.opt_state
        if self._graphed_opt is not opt.optimizer:
            self._graphed_opt, self._graphs, self._eager = opt.optimizer, {}, {}
        self.optimizer.set_lr(opt)
        key = tuple(seqs.shape)
        graph = self._graphs.get(key)
        if graph is not None:
            with span("train.replay"):
                loss = graph.replay(seqs, draws, times)
            STEP_GRAPHS["replays"] += 1
            return dataclasses.replace(state, opt_state=dataclasses.replace(
                opt, count=opt.count + 1)), loss
        for p in state.params.values():  # the backward writes the gradients anew
            p.grad = None
        if self._eager.get(key, 0) < WARMUP_STEPS or not self._captures():
            self._eager[key] = self._eager.get(key, 0) + 1
            return self._step(state, seqs, draws, times)
        with span("train.capture"):
            graph = _StepGraph(seqs, to_device(draws, self.device), times)
            state, loss = graph.capture(self._step, state)
        self._graphs[key] = graph
        STEP_GRAPHS["captures"] += 1
        return state, loss

    def _mesh_share(self, inp, seqs, draws: StepDraws) -> torch.Tensor:
        """This rank's share of the global batch's ``bpr + decay · reg``:
        its slice's BPR sum over the global weight total and its slice's
        reg sum over the global batch, divided by the model-axis copies
        (the shares sum to the single-card loss over the mesh)."""
        part = self._sh.batch_spec(seqs.shape[0])
        local = slice_rows(draws.model, part)
        loss, aux = self._sh.call(self.model, "next_item_bpr_loss", inp[part], seqs[part],
                                  draws.neg[part], local)
        w_local = self.model.loss_weight(seqs[part], local).float().sum().clamp(min=1.0)
        w_all = self.model.loss_weight(seqs, draws.model).float().sum().clamp(min=1.0)
        frac = (part.stop - part.start) / seqs.shape[0]
        return (aux["bpr"] * (w_local / w_all) + self.decay * aux["reg"] * frac) \
            / self.mesh.model_size

    def run_steps(self, state: SeqTrainState, batches, draws: Sequence[StepDraws],
                  times=None):
        """One optimizer step per (B, L) batch of ``batches`` with the
        given draws (and, for a model with times, each batch's ``times``)
        → (state, the per-step losses ``loss + decay · reg`` on the
        device)."""
        losses = []
        batches = torch.as_tensor(batches, device=self.device)
        times = [None] * len(batches) if times is None else torch.as_tensor(times,
                                                                            device=self.device)
        for seqs, d, t in zip(batches, draws, times):
            with span("train.step"):
                state, loss = self._train_step(state, seqs.long(), d,
                                               None if t is None else t.long())
            losses.append(loss)
        return state, self._global(torch.stack(losses))

    def _global(self, losses: torch.Tensor) -> torch.Tensor:
        """The ranks' loss shares summed into the steps' losses."""
        return losses if self.mesh is None else all_reduce_(losses, self.mesh)

    def _epoch_perm(self, epoch: int) -> torch.Tensor:
        """The epoch's permutation of the padded sequences (the last one
        drawn is kept)."""
        if self._perm is None or self._perm[0] != epoch:
            g = torch.Generator(self.device).manual_seed(stream_seed(self.seed, epoch, 0, _PERM))
            self._perm = (epoch, torch.randperm(self.train_seqs.shape[0], generator=g,
                                                device=self.device))
        return self._perm[1]

    def epoch_batches(self, epoch: int) -> torch.Tensor:
        """The epoch's (steps, B, L) batches: one permutation of the
        padded sequences."""
        return self.train_seqs[self._epoch_perm(epoch)].view(-1, self.batch_size,
                                                              self.data.max_len)

    def _batch_rows(self, epoch: int, step: int) -> torch.Tensor:
        B = self.batch_size
        return self._epoch_perm(epoch)[step * B:(step + 1) * B]

    def _batch(self, epoch: int, step: int) -> torch.Tensor:
        """Batch ``step`` of `epoch_batches` (``epoch``)."""
        return self.train_seqs[self._batch_rows(epoch, step)]

    def _batch_times(self, epoch: int, step: int) -> Optional[torch.Tensor]:
        """The times of `_batch` (``epoch``, ``step``); None without times."""
        if self.train_times is None:
            return None
        return self.train_times[self._batch_rows(epoch, step)]

    def step_generator(self, epoch: int, step: int) -> torch.Generator:
        return torch.Generator(self.device).manual_seed(
            stream_seed(self.seed, epoch, step, _STEP))

    def train_epoch(self, state: SeqTrainState) -> Tuple[SeqTrainState, float]:
        """One call: the rest of the epoch, or ``steps_per_call`` steps
        across epochs → (state, the mean step loss, read once)."""
        steps = self.steps_per_call or self.steps_per_epoch - state.step
        epoch, i = state.epoch, state.step
        losses = []
        with span("train.call", shape=(steps, self.batch_size, self.data.max_len)):
            for _ in range(steps):
                with span("train.step"):
                    seqs, times = self._batch(epoch, i), self._batch_times(epoch, i)
                    with span("train.sample"):
                        draws = self.draw_step(seqs, self.step_generator(epoch, i))
                    state, loss = self._train_step(state, seqs, draws, times)
                losses.append(loss)
                epoch, i = (epoch + 1, 0) if i + 1 == self.steps_per_epoch else (epoch, i + 1)
            mean = self._global(torch.stack(losses)).mean()
            with span("sync.train.loss"):
                mean = float(mean)
        return dataclasses.replace(state, epoch=epoch, step=i), mean

    # ------------------------------------------------------------------ eval
    @torch.no_grad()
    def evaluate(self, state: Optional[SeqTrainState] = None) -> Dict[str, float]:
        """Mean HR/recall, precision and NDCG at each k over the eval users,
        of the model's current parameters (``state.params`` are those)."""
        max_k = max(self.topks)
        totals: Dict[str, torch.Tensor] = {}
        with fp32_reduction():
            for seqs, users, weights, top in self._eval_batches(max_k):
                labels = topk_labels(top, self.target_bitset, users)
                gt = torch.ones(seqs.shape[0], device=self.device)
                for k, v in batch_metrics(labels, gt, weights, self.topks).items():
                    totals[k] = totals[k] + v if k in totals else v
        if not totals:
            return {}
        names = list(totals)
        values = torch.stack([totals[k] for k in names])
        if self.mesh is not None:
            all_reduce_(values, self.mesh, "data")
        values = values.cpu().tolist()
        return {k: v / max(self.n_eval, 1) for k, v in zip(names, values)}

    def _eval_batches(self, max_k: int):
        """Per eval batch (seqs, users, weights, top-``max_k`` item ids);
        on a mesh, of this rank's data slice, the catalog scored shard by
        shard and merged over the model axis."""
        if self.mesh is None:
            items = self.model.scoring_catalog()
            times = self._eval_times if self.uses_times else [None] * len(self._eval_seqs)
            for seqs, users, weights, t in zip(self._eval_seqs, self._eval_users,
                                               self._eval_weights, times):
                q = (self.model.scoring_query(seqs) if t is None
                     else self.model.scoring_query(seqs, t)).contiguous()
                scores = masked_scores(q, items, self.hist_bitset.index_select(0, users))
                yield seqs, users, weights, topk_scores(scores, max_k)[1]
            return
        from gsrs_tpu_torch.parallel.dist_train import sharded_topk
        from gsrs_tpu_torch.parallel.sharding import call_with

        full = self._sh.gathered(self.model)
        items = call_with(self.model, full, "scoring_catalog")[self._lo:self._hi].contiguous()
        part = self._sh.batch_spec(self.eval_batch)
        for seqs, users, weights in zip(self._eval_seqs, self._eval_users, self._eval_weights):
            seqs, users, weights = seqs[part], users[part], weights[part]
            q = call_with(self.model, full, "scoring_query", seqs).contiguous()
            _, top = sharded_topk(q, items, self._hist_shard.index_select(0, users), max_k,
                                  self.mesh, self._lo, self.data.m_items)
            yield seqs, users, weights, top

    # ------------------------------------------------------------------- fit
    def fit(
        self,
        state: Optional[SeqTrainState] = None,
        epochs: int = 100,
        checkpoint_dir: Optional[str] = None,
        eval_every: int = 10,
        resume: bool = False,
        verbose: bool = True,
        tensorboard: bool = False,
        comment: str = "",
    ) -> SeqTrainState:
        """The JAX trainer's loop: CSV and optional TensorBoard logs (under
        ``checkpoint_dir``), ``model_meta.json``, resume from the newest
        checkpoint, an eval before every ``eval_every``-th epoch with a
        best-NDCG checkpoint on improvement, ``last`` after every epoch,
        and a final eval of the last state. Without ``checkpoint_dir`` it
        is the epoch loop with its evals. It trains whole epochs:
        ``steps_per_call`` must be unset."""
        from gsrs_tpu_torch.models.registry import seq_model_meta
        from gsrs_tpu_torch.train.checkpoint import CheckpointManager
        from gsrs_tpu_torch.train.logging import (
            TensorboardWriter, make_train_csv, make_valid_csv,
        )

        if self.steps_per_call:
            raise ValueError("fit trains whole epochs: unset steps_per_call")
        state = state or self.init_state()
        primary = self.mesh is None or self.mesh.is_primary
        verbose = verbose and primary
        ckpt = train_csv = valid_csv = None
        tb = TensorboardWriter(
            checkpoint_dir if (tensorboard and checkpoint_dir and primary) else None,
            comment or f"seq-{self.data.name}")
        if checkpoint_dir:
            ckpt = CheckpointManager(checkpoint_dir)
            if primary:
                train_csv = make_train_csv(checkpoint_dir)
                valid_csv = make_valid_csv(checkpoint_dir, self.topks)
                with open(os.path.join(checkpoint_dir, "model_meta.json"), "w") as f:
                    json.dump(seq_model_meta(self.model), f)
            if resume:
                path = ckpt.resolve_resume_path(None) if primary else None
                if self.mesh is not None:
                    path = broadcast_object(path, self.mesh)
                if path is not None:
                    state = self.restore(state, ckpt.restore(path))
                    if verbose:
                        print(f"[resume] restored from {path} (epoch {state.epoch})")

        best_ndcg = 0.0
        main_k = max(self.topks)
        last_eval = -1
        try:
            while state.epoch < epochs:
                if state.epoch % eval_every == 0:
                    last_eval = state.epoch
                    metrics = self.evaluate(state)
                    self._log_eval(state, metrics, valid_csv, verbose, tb)
                    if ckpt and metrics.get(f"ndcg@{main_k}", 0.0) > best_ndcg:
                        best_ndcg = metrics[f"ndcg@{main_k}"]
                        self._save(ckpt.save_best, state, state.epoch)
                t0 = time.time()
                state, loss = self.train_epoch(state)
                dt = time.time() - t0
                tb.scalar("Train/loss", loss, state.epoch)
                if train_csv:
                    train_csv.append({"epoch": state.epoch, "time_sec": f"{dt:.3f}",
                                      "train_loss": f"{loss:.6f}", "lr": ""})
                if verbose:
                    print(f"[epoch {state.epoch}/{epochs}] loss={loss:.5f} ({dt:.2f}s)")
                if ckpt:
                    self._save(ckpt.save_last, state)
            if last_eval != state.epoch:
                metrics = self.evaluate(state)
                self._log_eval(state, metrics, valid_csv, verbose, tb)
                if ckpt and metrics.get(f"ndcg@{main_k}", 0.0) > best_ndcg:
                    self._save(ckpt.save_best, state, state.epoch)
        finally:
            tb.close()
        return state

    # ------------------------------------------------------------ checkpoint
    def ckpt_state(self, state: SeqTrainState) -> Dict[str, Any]:
        """A checkpoint: {params (by name), opt_state, epoch, and step
        where a call stopped inside the epoch}, the item table canonical
        (unpadded). On a mesh every rank calls it."""
        params, opt = self._sh.canonical_state(
            {k: p.detach() for k, p in state.params.items()},
            optimizer_state_dict(state.opt_state, state.params), self._canonical_rows)
        out = {"params": params, "opt_state": opt, "epoch": int(state.epoch)}
        if state.step:
            out["step"] = int(state.step)
        return out

    def _save(self, save, state: SeqTrainState, *args) -> None:
        """``save(checkpoint, *args)`` on rank 0 (every rank gathers)."""
        ckpt = self.ckpt_state(state)
        if self.mesh is None or self.mesh.is_primary:
            save(ckpt, *args)

    def restore(self, state: SeqTrainState, saved: Dict[str, Any]) -> SeqTrainState:
        """Copy a checkpoint's parameters into the live ones (on a mesh,
        this rank's rows of the padded table) and take its optimizer state
        and epoch."""
        if set(saved["params"]) != set(state.params):
            raise ValueError(f"the checkpoint's parameters {sorted(saved['params'])} differ "
                             f"from the model's {sorted(state.params)}")
        params, opt = self._sh.local_state(saved["params"], saved["opt_state"],
                                           self._canonical_rows)
        saved = {**saved, "params": params, "opt_state": opt}
        with torch.no_grad():
            for name, p in state.params.items():
                src = saved["params"][name]
                if src.shape != p.shape:
                    raise ValueError(f"{name}: checkpoint {tuple(src.shape)}, model "
                                     f"{tuple(p.shape)}")
                p.copy_(src)
        opt_state = load_optimizer_state(self.optimizer, state.params, saved["opt_state"])
        return SeqTrainState(state.params, opt_state, int(saved["epoch"]),
                             int(saved.get("step", 0)))

    def _log_eval(self, state, metrics, valid_csv, verbose, tb) -> None:
        tb.eval_metrics(metrics, self.topks, state.epoch)
        if valid_csv:
            row = {"epoch": state.epoch, "time_sec": "", "lr": ""}
            row.update({k: f"{v:.6f}" for k, v in metrics.items()})
            valid_csv.append(row)
        if verbose:
            print(f"[eval e{state.epoch}] "
                  + " ".join(f"{k}={v:.5f}" for k, v in sorted(metrics.items())))

