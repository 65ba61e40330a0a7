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
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from gsrs_tpu_torch.models._transformer import (
    dropout_masks, encode_transformer, init_encoder_params, next_item_bpr,
)
from gsrs_tpu_torch.models.sasrec import SeqModule


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

    @property
    def mask_token(self) -> int:
        return self.m_items + 1


class ClozeDraws(NamedTuple):
    """One step's draws: the corrupted sequence, the cloze mask (the
    loss's weights) and the dropout keep masks (None without dropout)."""

    corrupted: torch.Tensor
    masked: torch.Tensor
    keep: Optional[List[torch.Tensor]]


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class BERT4Rec(SeqModule):
    def _draw_params(self, generator):
        c = self.cfg
        return init_encoder_params(generator, vocab_rows=c.m_items + 2, max_len=c.max_len,
                                   d=c.embedding_dim, num_blocks=c.num_blocks,
                                   ffn_hidden=c.ffn_hidden)

    def encode(self, seqs: torch.Tensor,
               keep_masks: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """→ (B, L, d); keys must be real (non-PAD) positions."""
        c = self.cfg
        return encode_transformer(
            self.params(), seqs, (seqs != 0)[:, None, :], max_len=c.max_len,
            num_blocks=c.num_blocks, num_heads=c.num_heads, dropout_rate=c.dropout_rate,
            bf16_compute=c.bf16_compute, activation=gelu_tanh, keep_masks=keep_masks)

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

    def draw(self, generator: torch.Generator, pos: torch.Tensor) -> ClozeDraws:
        """One step's corruption of ``pos`` and dropout keep masks."""
        c = self.cfg
        corrupted, masked = self.cloze_mask(generator, pos)
        keep = dropout_masks(generator, (*pos.shape, c.embedding_dim), c.dropout_rate,
                             1 + 2 * c.num_blocks)
        return ClozeDraws(corrupted, masked, keep)

    def next_item_bpr_loss(self, seqs, pos, neg, draws: Optional[ClozeDraws] = None):
        """``seqs`` (the causal shift) is ignored: the cloze objective
        corrupts ``pos``, the full sequence, as ``draws`` says."""
        del seqs
        if draws is None:
            raise ValueError("BERT4Rec.next_item_bpr_loss needs the step's cloze draws: the "
                             "corruption is drawn anew every step (SeqTrainer passes them)")
        h = self.encode(draws.corrupted, draws.keep)
        return next_item_bpr(h, self.item_emb, pos, neg, draws.masked)

    def loss_weight(self, pos: torch.Tensor, draws: ClozeDraws) -> torch.Tensor:
        """The cloze objective weighs the masked positions."""
        return draws.masked

    def user_representations(self, seqs: torch.Tensor) -> torch.Tensor:
        """(B, d): the history shifted left one slot with MASK appended;
        that position's hidden state is the next-item query."""
        mask = torch.full((seqs.shape[0], 1), self.cfg.mask_token, dtype=seqs.dtype,
                          device=seqs.device)
        return self.encode(torch.cat([seqs[:, 1:], mask], dim=1))[:, -1, :]
