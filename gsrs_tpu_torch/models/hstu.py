"""HSTU, the Hierarchical Sequential Transduction Unit (Zhai et al., "Actions
Speak Louder than Words", ICML 2024, arXiv:2402.17152, §3 Eqs. 1–3 and
§4.1), on the port's sequential layout: B sequences of N slots,
left-padded, most recent last, id 0 = PAD, each slot with its item's
time in seconds.

With d the model width, H heads of width d_h (d_qk = d_v), L blocks and
m items (the item table E has m + 1 rows, row 0 PAD), and ``LN`` a
LayerNorm with eps 1e-6 and no affine terms:

- input: x⁰_i = Dropout(√d · E[s_i] + P[i]) · 1[s_i ≠ 0], P a learned
  (N, d) table indexed by the slot;
- block (Eq. 1): [U, V, Q, K] = Split(SiLU(LN(X) W₁)), W₁ (d, 4·H·d_h)
  without bias;
- pointwise attention (Eq. 2), per head h: A_h = SiLU(Q_h K_hᵀ + rab) / N
  ⊙ M, with N the padded length and M_ij = 1[j ≤ i] · 1[s_j ≠ 0] (the
  port pads on the left, so PAD keys are masked: what a PAD slot holds
  changes no real slot's output); no dropout on A;
- output (Eq. 3): X ← X + Dropout(U ⊙ LN(concat_h A_h V_h)) W₂ + b₂,
  W₂ (H·d_h, d);
- the relative bias, one a block, shared by its heads: rab_ij =
  p[N − 1 + j − i] + w[b(τ_i − t_j)], p of 2N − 1 and w of
  `NUM_BUCKETS` + 1 entries, b(Δ) = clamp(⌊ln(max(|Δ|, 1)) / 0.301⌋, 0,
  128) (`bucket_ids`, computed once a step for every block), t_j the time
  of slot j's input and τ_i that of the item slot i predicts (in the
  trainer's shifted layout the time of the target at slot i; where slot i
  has no target, as at the eval query's last slot, its own input's time);
- output embedding z_i = x^L_i / max(‖x^L_i‖, 1e-6);
- loss (the released code's sampled softmax with local negatives): at
  every slot with a real input and a real target y_i, K = `NEGATIVES`
  negatives n_ik drawn uniformly over [1, m] (`draw_negatives`, 0 at PAD
  targets), ê = e / max(‖e‖, 1e-6) for rows e of E, temperature T =
  `TEMPERATURE` (the released ML-20M settings' 128 and 0.05):
  ℓ_i = −log softmax([z_i·ê_y, z_i·ê_n1, …] / T)₀, a negative equal to
  y_i at logit −5·10⁴; the loss is the mean of ℓ_i over those slots.

The head normalises the whole table once and gathers the rows of its
1 + K ids a slot from it; the gathers (the input's rows, the head's rows
and the two bias tables, each a one-column table) go through
`ops.gather.gather_rows`, whose backward on the card is the
deterministic ``gather_rows_grad`` kernel. That kernel sums a long run of
one id with one warp at the end, so two runs that carry only zeros are
spread over the table's rows (`spread_ids`): the bias's ids at masked
pairs (A masks them, so their gradient is 0: PAD keys' gaps of decades
and the future keys fill a few buckets with millions of ids), and the
head's ids at slots outside the loss (their gradient is 0: a PAD
target's 1 + K ids are all row 0). The values the loss and every real
slot see, and every gradient, are the equations'.

The head computes every slot, PAD ones included (a head over real slots
only is not written yet): `draw_negatives` records the span
``hstu.negatives`` with ``shape`` (slots computed, K) and adds the slots
to ``HEAD_ROWS["rows"]`` at every step, so a replayed step counts too.
Spans of the forward: ``seq.encode``, ``hstu.rab`` (``shape`` (B, N,
NUM_BUCKETS + 1), the bucket ids), ``hstu.block`` one a block (``shape``
(B, H, N, d_h)) and ``seq.head`` (``shape`` (slots computed, K, d)).

Eval and serving rank by the training similarity: `scoring_query` is z
at the last slot, `scoring_catalog` the normalised real rows ê.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from gsrs_tpu_torch.models._transformer import apply_dropout, dropout_masks
from gsrs_tpu_torch.models.sasrec import SeqModule
from gsrs_tpu_torch.ops.gather import gather_rows
from gsrs_tpu_torch.utils.timer import span

NUM_BUCKETS = 128  # the time buckets past the first: w has NUM_BUCKETS + 1 entries
BUCKET_LOG_WIDTH = 0.301
LN_EPS = 1e-6
L2_EPS = 1e-6
COLLISION_LOGIT = -5e4  # a negative equal to its slot's target
NEGATIVES = 128  # the sampled softmax's negatives a slot
TEMPERATURE = 0.05  # the sampled softmax's temperature
HEAD_ROWS = {"rows": 0}  # the slots the head computed, summed over steps


@dataclasses.dataclass(frozen=True)
class HSTUConfig:
    m_items: int  # real item count; the table has m_items + 1 rows (PAD = 0)
    max_len: int = 200
    embedding_dim: int = 256
    num_blocks: int = 8
    num_heads: int = 4
    head_dim: int = 64  # d_qk = d_v
    dropout_rate: float = 0.2


class HSTUDraws(NamedTuple):
    """One step's dropout keep masks: the input's (B, N, d), then one a
    block (B, N, H·d_h); None without dropout."""

    keep: Optional[List[torch.Tensor]]


def bucket_ids(t_in: torch.Tensor, t_tgt: torch.Tensor) -> torch.Tensor:
    """(B, N, N) int64 time buckets b(τ_i − t_j) of the (B, N) input times
    ``t_in`` (t_j) and target times ``t_tgt`` (τ_i), in seconds."""
    delta = (t_tgt[:, :, None] - t_in[:, None, :]).abs().clamp(min=1).double()
    return (torch.log(delta) / BUCKET_LOG_WIDTH).floor().clamp(0, NUM_BUCKETS).long()


def spread_ids(ids: torch.Tensor, keep: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``ids`` where ``keep``, elsewhere ids cycling over [lo, hi] by
    position: for gathers whose gradient is 0 there (the module's note)."""
    cycle = torch.arange(ids.numel(), device=ids.device).view(ids.shape) % (hi - lo + 1) + lo
    return torch.where(keep, ids, cycle)


def target_times(times: torch.Tensor) -> torch.Tensor:
    """τ of an unshifted sequence's slots: the next slot's time, the last
    slot's own time repeated (the eval query's layout)."""
    return torch.cat([times[:, 1:], times[:, -1:]], dim=1)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp(min=L2_EPS)


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), eps=LN_EPS)


class HSTU(SeqModule):
    """Parameters: ``item_emb`` (m + 1, d), ``pos_emb`` (N, d), and per
    block ``b{l}_uvqk`` (d, 4·H·d_h), ``b{l}_o`` (H·d_h, d), ``b{l}_o_b``
    (d,), ``b{l}_pos_w`` (2N − 1,) and ``b{l}_ts_w`` (NUM_BUCKETS + 1,)."""

    uses_times = True  # its batches carry each slot's time

    def _draw_params(self, generator):
        c = self.cfg
        d, w = c.embedding_dim, c.num_heads * c.head_dim

        def normal(*shape, std):
            return torch.randn(shape, generator=generator) * std

        # normal forms of the released initialisers: truncated normals for
        # the tables, Xavier for W₁, nn.Linear's for W₂ and b₂
        params = {"item_emb": normal(c.m_items + 1, d, std=0.02),
                  "pos_emb": normal(c.max_len, d, std=math.sqrt(1.0 / d))}
        for b in range(c.num_blocks):
            params[f"b{b}_uvqk"] = normal(d, 4 * w, std=math.sqrt(2.0 / (d + 4 * w)))
            params[f"b{b}_o"] = normal(w, d, std=math.sqrt(1.0 / (3 * w)))
            params[f"b{b}_o_b"] = normal(d, std=math.sqrt(1.0 / (3 * w)))
            params[f"b{b}_pos_w"] = normal(2 * c.max_len - 1, std=0.02)
            params[f"b{b}_ts_w"] = normal(NUM_BUCKETS + 1, std=0.02)
        return params

    # ---------------------------------------------------------------- draws
    def draw_negatives(self, generator: torch.Generator, pos: torch.Tensor) -> torch.Tensor:
        """(B, N, K) negatives uniform over [1, m], 0 where the target is
        PAD, on the generator's device."""
        c = self.cfg
        B, N = pos.shape
        with span("hstu.negatives", shape=(B * N, NEGATIVES)):
            neg = torch.randint(1, c.m_items + 1, (B, N, NEGATIVES), generator=generator,
                                device=generator.device)
            neg = torch.where(pos.to(generator.device)[..., None] == 0, 0, neg)
        HEAD_ROWS["rows"] += B * N
        return neg

    def draw(self, generator: torch.Generator, pos: torch.Tensor) -> HSTUDraws:
        """One step's dropout keep masks (the input's, then one a block)."""
        c = self.cfg
        B, N = pos.shape
        keep = dropout_masks(generator, (B, N, c.embedding_dim), c.dropout_rate, 1)
        if keep is not None:
            keep += dropout_masks(generator, (B, N, c.num_heads * c.head_dim), c.dropout_rate,
                                  c.num_blocks)
        return HSTUDraws(keep)

    # -------------------------------------------------------------- encoder
    def attention_mask(self, seqs: torch.Tensor) -> torch.Tensor:
        """(B, N, N) bool M: causal, and the key's input real."""
        N = seqs.shape[1]
        causal = torch.tril(torch.ones(N, N, dtype=torch.bool, device=seqs.device))
        return causal[None] & (seqs != 0)[:, None, :]

    def relative_bias(self, b: int, buckets: torch.Tensor) -> torch.Tensor:
        """Block ``b``'s (B, N, N) bias p[N − 1 + j − i] + w[bucket_ij]."""
        N = buckets.shape[1]
        ar = torch.arange(N, device=buckets.device)
        rel = (N - 1) + ar[None, :] - ar[:, None]
        pos_w = getattr(self, f"b{b}_pos_w")
        ts_w = getattr(self, f"b{b}_ts_w")
        return gather_rows(pos_w[:, None], rel)[None, ..., 0] + gather_rows(ts_w[:, None],
                                                                             buckets)[..., 0]

    def encode(self, seqs: torch.Tensor, t_in: torch.Tensor, t_tgt: torch.Tensor,
               keep: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """(B, N, d) states x^L of the input ``seqs`` with input times
        ``t_in`` and target times ``t_tgt``; ``keep``: 1 + L keep masks,
        or None for no dropout."""
        c = self.cfg
        B, N = seqs.shape
        H, dh = c.num_heads, c.head_dim
        masks = iter(keep) if keep is not None and c.dropout_rate > 0.0 else None
        if masks is not None and len(keep) != 1 + c.num_blocks:
            raise ValueError(f"{len(keep)} keep masks for {1 + c.num_blocks} dropout sites")

        def dropout(t):
            return t if masks is None else apply_dropout(t, next(masks), c.dropout_rate)

        x = gather_rows(self.item_emb, seqs) * math.sqrt(c.embedding_dim) + self.pos_emb[None]
        x = dropout(x) * (seqs != 0)[..., None]
        mask = self.attention_mask(seqs)
        with span("hstu.rab", shape=(B, N, NUM_BUCKETS + 1)):
            buckets = spread_ids(bucket_ids(t_in, t_tgt), mask, 0, NUM_BUCKETS)
        mask = mask[:, None]
        for b in range(c.num_blocks):
            with span("hstu.block", shape=(B, H, N, dh)):
                rab = self.relative_bias(b, buckets)
                uvqk = F.silu(_layer_norm(x) @ getattr(self, f"b{b}_uvqk"))
                u, v, q, k = uvqk.split(H * dh, dim=-1)
                scores = torch.einsum("bnhd,bmhd->bhnm", q.reshape(B, N, H, dh),
                                      k.reshape(B, N, H, dh))
                a = F.silu(scores + rab[:, None]) / N * mask
                attn = torch.einsum("bhnm,bmhd->bnhd", a, v.reshape(B, N, H, dh))
                o = dropout(u * _layer_norm(attn.reshape(B, N, H * dh)))
                x = x + o @ getattr(self, f"b{b}_o") + getattr(self, f"b{b}_o_b")
        return x

    # ----------------------------------------------------------------- loss
    def exclude_collisions(self, logits: torch.Tensor, pos: torch.Tensor,
                           neg: torch.Tensor) -> torch.Tensor:
        """``logits`` (…, 1 + K) with each negative equal to its target set
        to `COLLISION_LOGIT`."""
        hit = torch.cat([torch.zeros_like(pos[..., None], dtype=torch.bool),
                         neg == pos[..., None]], dim=-1)
        return logits.masked_fill(hit, COLLISION_LOGIT)

    def next_item_bpr_loss(self, seqs, pos, neg, draws: Optional[HSTUDraws] = None,
                           times: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """The sampled-softmax loss (the module's note) of the input
        ``seqs`` (the causal shift), targets ``pos``, negatives ``neg`` (B,
        N, K), ``draws``' keep masks and ``times`` = (input times, target
        times) → (loss, {"softmax", "reg" (0)})."""
        if times is None:
            raise ValueError("HSTU's loss needs each slot's time: the trainer passes the "
                             "batch's times (a dataset with times)")
        c = self.cfg
        B, N = seqs.shape
        with span("seq.encode"):
            z = l2_normalize(self.encode(seqs, *times, None if draws is None else draws.keep))
        with span("seq.head", shape=(B * N, NEGATIVES, c.embedding_dim)):
            w = self.loss_weight(pos, draws, seqs)
            ids = spread_ids(torch.cat([pos[..., None], neg], -1), w[..., None], 1, c.m_items)
            rows = gather_rows(l2_normalize(self.item_emb), ids)
            logits = torch.einsum("bnd,bnkd->bnk", z, rows) / TEMPERATURE
            logits = self.exclude_collisions(logits, pos, neg)
            nll = -torch.log_softmax(logits, dim=-1)[..., 0]
            w = w.to(nll.dtype)
            loss = (nll * w).sum() / w.sum().clamp(min=1.0)
        return loss, {"softmax": loss, "reg": torch.zeros((), device=loss.device)}

    def loss_weight(self, pos: torch.Tensor, draws=None, seqs=None) -> torch.Tensor:
        """The slots in the loss: a real target, and a real input (the
        shifted ``seqs``; every slot after a sequence's first has one)."""
        w = pos != 0
        if seqs is None:
            seqs = torch.zeros_like(pos)
            seqs[:, 1:] = pos[:, :-1]
        return w & (seqs != 0)

    # --------------------------------------------------------------- scoring
    def scoring_query(self, seqs: torch.Tensor,
                      times: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, d): z at the last slot of the (unshifted) history ``seqs``
        with its (B, N) ``times``."""
        if times is None:
            raise ValueError("HSTU scores a history with its times (a dataset with times)")
        return l2_normalize(self.encode(seqs, times, target_times(times))[:, -1, :])

    def scoring_catalog(self) -> torch.Tensor:
        """(m, d): the real items' normalised rows ê."""
        return l2_normalize(self.catalog())
