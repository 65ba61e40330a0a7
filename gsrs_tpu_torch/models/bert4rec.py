"""BERT4Rec, the bidirectional cloze model (port of
`gsrs_tpu.models.bert4rec`).

Vocabulary: 0 = PAD, 1..m = items (shifted ids), m + 1 = MASK; the table
has m + 2 rows. Every position attends to every non-PAD position, and the
FFN's GELU is the tanh approximation (`jax.nn.gelu`'s default; torch's
default is the exact erf form). Training corrupts the full sequence with
the cloze mask and scores the masked positions pairwise against the
negatives, weighted by the mask. The corruption is drawn apart from the
loss (`cloze_mask`, `draw`) and handed to it, so a caller can hand the
port JAX's corruption. Retrieval shifts the history left one slot,
appends MASK and scores that position's hidden state.

The published model (Sun et al., CIKM 2019, arXiv:1904.06690) is one
option, ``published``, off (0) by default; its value P is the prediction
slots a sequence. It takes, together:

- Eqs. 4–5's post-LN blocks, h⁰ = v + p (`_transformer`);
- Eq. 7's head, P(v) = softmax(GELU(h·W^P + b^P)·Eᵀ + b^O), E the item
  table's real rows (tied), W^P ``head_w`` (d × d), b^P ``head_b``, b^O
  ``out_bias`` (one per item). Eval and serving rank by the same scores:
  K1 over (q ‖ 1) against (E ‖ b^O), each padded with zero columns to a
  width that divides by 4 (`scoring_query`, `scoring_catalog`);
- the published cloze and its loss. Of a sequence's n real positions
  exactly min(P, n, max(1, round(mask_prob · n))) are chosen uniformly
  and all replaced by MASK, and their positions and weights are gathered
  into P slots (BERT's ``masked_lm_positions``/``masked_lm_weights``:
  sorted, the empty slots at position 0 with weight 0); a share
  ``last_only_prob`` of the sequences masks only its last item. The loss
  is the softmax cross-entropy of each slot's item over the m real items
  (PAD and MASK excluded), Σ w · nll / (Σ w + 1e-5), as the released
  code's ``masked_lm`` loss.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from gsrs_tpu_torch.models._transformer import (
    dropout_masks, encode_transformer, init_encoder_params, next_item_bpr,
)
from gsrs_tpu_torch.models.sasrec import SeqModule
from gsrs_tpu_torch.utils.timer import span


@dataclasses.dataclass(frozen=True)
class BERT4RecConfig:
    m_items: int  # real item count; the table has m_items + 2 rows (PAD, items, MASK)
    max_len: int = 50
    embedding_dim: int = 64
    num_blocks: int = 2
    num_heads: int = 1
    ffn_hidden: int = 64
    dropout_rate: float = 0.2
    mask_prob: float = 0.3
    # share of sequences trained as next-item samples: only the final
    # position masked, its context clean (the retrieval query's conditioning)
    last_only_prob: float = 0.6
    bf16_compute: bool = False
    # the published model (module note) with this many prediction slots a
    # sequence; 0: the JAX package's model
    published: int = 0

    @property
    def mask_token(self) -> int:
        return self.m_items + 1


class ClozeDraws(NamedTuple):
    """One step's draws: the corrupted sequence, the cloze mask (the
    loss's weights) and the dropout keep masks (None without dropout);
    the published cloze also gives its (B, P) slots' positions and
    weights (bool)."""

    corrupted: torch.Tensor
    masked: torch.Tensor
    keep: Optional[List[torch.Tensor]]
    positions: Optional[torch.Tensor] = None
    weights: Optional[torch.Tensor] = None


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class BERT4Rec(SeqModule):
    def __init__(self, cfg: BERT4RecConfig, *args, **kwargs):
        if cfg.published > cfg.max_len:
            raise ValueError(f"published's {cfg.published} slots exceed max_len {cfg.max_len}")
        super().__init__(cfg, *args, **kwargs)

    def _draw_params(self, generator):
        c = self.cfg
        d = c.embedding_dim
        params = init_encoder_params(generator, vocab_rows=c.m_items + 2, max_len=c.max_len,
                                     d=d, num_blocks=c.num_blocks, ffn_hidden=c.ffn_hidden,
                                     final_ln=not c.published)
        if c.published:
            params["head_w"] = torch.randn((d, d), generator=generator) * math.sqrt(1.0 / d)
            params["head_b"] = torch.zeros(d)
            params["out_bias"] = torch.zeros(c.m_items)
        return params

    def encode(self, seqs: torch.Tensor,
               keep_masks: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """→ (B, L, d); keys must be real (non-PAD) positions."""
        c = self.cfg
        return encode_transformer(
            self.params(), seqs, (seqs != 0)[:, None, :], max_len=c.max_len,
            num_blocks=c.num_blocks, num_heads=c.num_heads, dropout_rate=c.dropout_rate,
            bf16_compute=c.bf16_compute, activation=gelu_tanh, keep_masks=keep_masks,
            post_ln=bool(c.published))

    def cloze_from_draws(self, seqs: torch.Tensor, position_draw: torch.Tensor,
                         last_only: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The corruption from its two draws: ``position_draw`` (B, L)
        bool, each position masked with probability mask_prob, and
        ``last_only`` (B,) bool, the sequences that mask exactly their
        final position. PAD is never masked; a sequence with nothing
        masked masks its final position. → (corrupted, masked)."""
        valid = seqs != 0
        masked = position_draw & valid
        last = torch.zeros_like(masked)
        last[:, -1] = True
        last &= valid
        masked = torch.where(last_only[:, None], last, masked)
        none_masked = ~masked.any(dim=1)
        masked = masked | (none_masked[:, None] & last)
        return torch.where(masked, self.cfg.mask_token, seqs), masked

    def cloze_mask(self, generator: torch.Generator,
                   seqs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Draw the cloze corruption of ``seqs`` on the generator's device."""
        c = self.cfg
        dev = generator.device
        position_draw = torch.rand(seqs.shape, generator=generator, device=dev) < c.mask_prob
        last_only = torch.rand(seqs.shape[0], generator=generator, device=dev) < c.last_only_prob
        return self.cloze_from_draws(seqs, position_draw.to(seqs.device),
                                     last_only.to(seqs.device))

    def published_cloze(self, generator: torch.Generator, seqs: torch.Tensor):
        """The published cloze of ``seqs`` (the module's note), drawn on the
        generator's device → (corrupted, masked, positions, weights)."""
        c = self.cfg
        dev = generator.device
        B, L = seqs.shape
        P = c.published
        valid = seqs != 0
        n = valid.sum(dim=1)
        want = torch.round(n.double() * c.mask_prob).long().clamp(1, P)
        keys = torch.rand((B, L), generator=generator, device=dev).to(seqs.device)
        last_only = (torch.rand(B, generator=generator, device=dev) < c.last_only_prob
                     ).to(seqs.device)
        count = torch.minimum(torch.where(last_only, 1, want), n)
        keys = torch.where(valid, keys, 2.0)  # PAD after every real position
        keys[:, -1] = torch.where(last_only, -1.0, keys[:, -1])  # the last item first
        chosen = torch.argsort(keys, dim=1)[:, :P]
        in_slot = torch.arange(P, device=seqs.device)[None, :] < count[:, None]
        positions = torch.where(in_slot, chosen, L).sort(dim=1).values
        weights = positions < L
        masked = torch.zeros((B, L + 1), dtype=torch.bool, device=seqs.device)
        masked.scatter_(1, positions, True)
        masked = masked[:, :L]
        corrupted = torch.where(masked, c.mask_token, seqs)
        return corrupted, masked, torch.where(weights, positions, 0), weights

    def draw(self, generator: torch.Generator, pos: torch.Tensor) -> ClozeDraws:
        """One step's corruption of ``pos`` and dropout keep masks."""
        c = self.cfg
        if c.published:
            corrupted, masked, positions, weights = self.published_cloze(generator, pos)
        else:
            (corrupted, masked), positions, weights = self.cloze_mask(generator, pos), None, None
        keep = dropout_masks(generator, (*pos.shape, c.embedding_dim), c.dropout_rate,
                             1 + 2 * c.num_blocks)
        return ClozeDraws(corrupted, masked, keep, positions, weights)

    def next_item_bpr_loss(self, seqs, pos, neg, draws: Optional[ClozeDraws] = None):
        """``seqs`` (the causal shift) is ignored: the cloze objective
        corrupts ``pos``, the full sequence, as ``draws`` says. The
        published model's loss is the slots' softmax cross-entropy
        (`cloze_softmax_loss`), and ``neg`` is not used."""
        del seqs
        if draws is None:
            raise ValueError("BERT4Rec.next_item_bpr_loss needs the step's cloze draws: the "
                             "corruption is drawn anew every step (SeqTrainer passes them)")
        if self.cfg.published:
            return self.cloze_softmax_loss(pos, draws)
        h = self.encode(draws.corrupted, draws.keep)
        return next_item_bpr(h, self.item_emb, pos, neg, draws.masked)

    def head_query(self, h: torch.Tensor) -> torch.Tensor:
        """Eq. 7's transform of hidden states: GELU(h·W^P + b^P); ``h``
        itself in the JAX package's model."""
        if not self.cfg.published:
            return h
        return gelu_tanh(h @ self.head_w + self.head_b)

    def output_logits(self, hs: torch.Tensor) -> torch.Tensor:
        """(S, m) logits of hidden states ``hs`` (S, d) over the real items:
        Eq. 7's GELU(hs·W^P + b^P)·Eᵀ + b^O in the published model (b^O
        added in the product's epilogue, not in a pass of its own), else
        hs·Eᵀ."""
        if not self.cfg.published:
            return hs @ self.catalog().T
        return torch.addmm(self.out_bias, self.head_query(hs), self.catalog().T)

    def cloze_softmax_loss(self, pos: torch.Tensor, draws: ClozeDraws):
        """The weighted softmax cross-entropy of the slots' items over the
        catalog → (loss, {"softmax", "reg" (0: no BPR L2 term)})."""
        c = self.cfg
        d = c.embedding_dim
        with span("seq.encode"):
            h = self.encode(draws.corrupted, draws.keep)
        slots = draws.positions.numel()
        with span("seq.head", shape=(slots, c.m_items, d)):
            hs = h.gather(1, draws.positions[..., None].expand(-1, -1, d)).reshape(slots, d)
            logits = self.output_logits(hs)
            w = draws.weights.reshape(-1)
            labels = torch.where(w, pos.gather(1, draws.positions).reshape(-1) - 1, 0)
            nll = F.cross_entropy(logits, labels, reduction="none")
            w = w.to(nll.dtype)
            loss = (nll * w).sum() / (w.sum() + 1e-5)
        return loss, {"softmax": loss, "reg": torch.zeros((), device=loss.device)}

    def loss_weight(self, pos: torch.Tensor, draws: ClozeDraws) -> torch.Tensor:
        """The cloze objective weighs the masked positions."""
        return draws.masked

    def _pad_width(self) -> int:
        """Zero columns after (q ‖ 1) and (E ‖ b^O): the width divides by 4."""
        return -(self.cfg.embedding_dim + 1) % 4

    def scoring_query(self, seqs: torch.Tensor) -> torch.Tensor:
        """The query K1 scores; in the published model, (GELU(h·W^P + b^P) ‖
        1 ‖ 0…), whose product with `scoring_catalog`'s rows is Eq. 7's
        logit."""
        q = self.head_query(self.user_representations(seqs))
        if not self.cfg.published:
            return q
        ones = q.new_ones((q.shape[0], 1))
        return torch.cat([q, ones, q.new_zeros((q.shape[0], self._pad_width()))], dim=1)

    def scoring_catalog(self) -> torch.Tensor:
        """The rows K1 scores against; in the published model, (E ‖ b^O ‖
        0…)."""
        items = self.catalog()
        if not self.cfg.published:
            return items
        m = items.shape[0]
        return torch.cat([items, self.out_bias[:, None],
                          items.new_zeros((m, self._pad_width()))], dim=1)

    def user_representations(self, seqs: torch.Tensor) -> torch.Tensor:
        """(B, d): the history shifted left one slot with MASK appended;
        that position's hidden state is the next-item query."""
        mask = torch.full((seqs.shape[0], 1), self.cfg.mask_token, dtype=seqs.dtype,
                          device=seqs.device)
        return self.encode(torch.cat([seqs[:, 1:], mask], dim=1))[:, -1, :]
