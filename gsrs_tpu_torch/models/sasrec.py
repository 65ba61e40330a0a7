"""SASRec, the causal self-attention next-item model (port of
`gsrs_tpu.models.sasrec`).

An `nn.Module` holding the JAX package's parameters under their names
(`models._transformer`). Position t attends to positions ≤ t that are
not PAD; the loss is BPR on (next item, negative) at every valid
position; retrieval scores the last position's hidden state against the
item table's real rows. Dropout masks are drawn apart from the loss
(`draw`), so a caller can hand the port any draws, JAX's included.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from gsrs_tpu_torch.device import DeviceLike, resolve_device
from gsrs_tpu_torch.models._transformer import (
    dropout_masks, encode_transformer, init_encoder_params, next_item_bpr,
)


@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    m_items: int  # real item count; the table has m_items + 1 rows (PAD = 0)
    max_len: int = 50
    embedding_dim: int = 64
    num_blocks: int = 2
    num_heads: int = 1
    ffn_hidden: int = 64
    dropout_rate: float = 0.2
    bf16_compute: bool = False


class SeqModule(nn.Module):
    """What the three sequential models share: parameters registered
    under the JAX package's names, drawn by `_draw_params` on the host
    (a seed gives the same weights on every device), the real item rows
    for scoring, and `score_catalog`."""

    def __init__(self, cfg, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        for name, t in self._draw_params(self._generator(generator)).items():
            self.register_parameter(name, nn.Parameter(t.to(device)))

    @staticmethod
    def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
        return generator if generator is not None else torch.Generator().manual_seed(0)

    def _draw_params(self, generator: torch.Generator) -> dict:
        raise NotImplementedError

    @torch.no_grad()
    def init_params(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw every parameter again from ``generator`` (seed 0 when None)."""
        for name, t in self._draw_params(self._generator(generator)).items():
            getattr(self, name).copy_(t)

    def params(self) -> dict:
        return dict(self.named_parameters())

    def loss_weight(self, pos: torch.Tensor, draws=None) -> torch.Tensor:
        """The (B, L) weights of the loss's BPR terms: the positions with a
        next item (a mesh rank scales its share of the loss by them)."""
        return pos != 0

    def catalog(self) -> torch.Tensor:
        """The (m_items, d) rows of the real items (PAD and MASK rows
        dropped), contiguous: a row slice of the table, no copy."""
        return self.item_emb[1:self.cfg.m_items + 1]

    def scoring_query(self, seqs: torch.Tensor) -> torch.Tensor:
        """(B, w) queries whose products with `scoring_catalog`'s rows are
        the scores: the next-item query itself, unless the model's output
        layer adds to it (BERT4Rec's Eq. 7 head)."""
        return self.user_representations(seqs)

    def scoring_catalog(self) -> torch.Tensor:
        """(m_items, w) rows that eval and serving score against."""
        return self.catalog()

    def score_catalog(self, seqs: torch.Tensor) -> torch.Tensor:
        """(B, m_items) scores over real 0-based item ids, fp32 (the plain
        product; eval and serving score through the masked kernel)."""
        return self.scoring_query(seqs) @ self.scoring_catalog().T


class SASRec(SeqModule):
    def _draw_params(self, generator):
        c = self.cfg
        return init_encoder_params(generator, vocab_rows=c.m_items + 1, max_len=c.max_len,
                                   d=c.embedding_dim, num_blocks=c.num_blocks,
                                   ffn_hidden=c.ffn_hidden)

    def encode(self, seqs: torch.Tensor,
               keep_masks: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """→ (B, L, d); the mask is causal ∧ key-valid."""
        c = self.cfg
        causal = torch.tril(torch.ones(c.max_len, c.max_len, dtype=torch.bool,
                                       device=seqs.device))
        attn_mask = causal[None] & (seqs != 0)[:, None, :]
        return encode_transformer(
            self.params(), seqs, attn_mask, max_len=c.max_len, num_blocks=c.num_blocks,
            num_heads=c.num_heads, dropout_rate=c.dropout_rate, bf16_compute=c.bf16_compute,
            activation=torch.relu, keep_masks=keep_masks)

    def draw(self, generator: torch.Generator, pos: torch.Tensor):
        """One step's dropout keep masks (None without dropout)."""
        c = self.cfg
        return dropout_masks(generator, (*pos.shape, c.embedding_dim), c.dropout_rate,
                             1 + 2 * c.num_blocks)

    def next_item_bpr_loss(self, seqs, pos, neg, draws=None):
        """``seqs`` (B, L) history, ``pos`` the next item per position (0
        where none), ``neg`` the negatives, ``draws`` `draw`'s masks."""
        h = self.encode(seqs, draws)
        return next_item_bpr(h, self.item_emb, pos, neg, pos != 0)

    def user_representations(self, seqs: torch.Tensor) -> torch.Tensor:
        """(B, d): the last position's hidden state, the next-item query."""
        return self.encode(seqs)[:, -1, :]


def make_training_arrays(
    train_seqs: np.ndarray, m_items: int, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(input, pos, neg) for next-item BPR: the input is the sequence
    shifted right one position, pos the sequence, negatives uniform over
    the real ids and 0 where pos is PAD."""
    inp = np.zeros_like(train_seqs)
    inp[:, 1:] = train_seqs[:, :-1]
    pos = train_seqs.copy()
    neg = rng.integers(1, m_items + 1, train_seqs.shape).astype(np.int32)
    neg = np.where(pos == 0, 0, neg)
    return inp, pos, neg
