"""GRU4Rec, the recurrent next-item model (port of
`gsrs_tpu.models.gru4rec`).

The recurrence is written as JAX writes it: the input projection of the
whole sequence first, then one step per position with fused gates
[reset, update, candidate] (``wx`` (in, 3h), ``wh`` (h, 3h), one bias),
and at a PAD position the state carried through unchanged,
``h = v·h_new + (1 − v)·h_prev``, so left padding does not move it.
`nn.GRU` cannot express that carry (and its gate layout differs), so the
steps are plain torch ops. ``out_proj`` maps the hidden state onto the
item space for the loss and for retrieval.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch

from gsrs_tpu_torch.models._transformer import apply_dropout, dropout_masks, next_item_bpr
from gsrs_tpu_torch.models.sasrec import SeqModule
from gsrs_tpu_torch.ops.linalg import fp32_reduction


@dataclasses.dataclass(frozen=True)
class GRU4RecConfig:
    m_items: int
    max_len: int = 50
    embedding_dim: int = 64
    hidden_dim: int = 64
    num_layers: int = 1
    dropout_rate: float = 0.1
    bf16_compute: bool = False


class GRU4Rec(SeqModule):
    def _draw_params(self, generator):
        c = self.cfg

        def glorot(i, o):
            return torch.randn((i, o), generator=generator) * math.sqrt(2.0 / (i + o))

        params = {
            "item_emb": 0.1 * torch.randn((c.m_items + 1, c.embedding_dim), generator=generator),
            "out_proj": glorot(c.hidden_dim, c.embedding_dim),
        }
        h = c.hidden_dim
        for layer in range(c.num_layers):
            in_dim = c.embedding_dim if layer == 0 else h
            params[f"l{layer}_wx"] = glorot(in_dim, 3 * h)
            params[f"l{layer}_wh"] = glorot(h, 3 * h)
            params[f"l{layer}_b"] = torch.zeros(3 * h)
        return params

    def encode(self, seqs: torch.Tensor,
               keep_masks: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """→ (B, L, hidden) fp32 hidden states. ``keep_masks``: one keep
        mask of the embeddings' shape (B, L, d), or None."""
        c = self.cfg
        cd = torch.bfloat16 if c.bf16_compute else torch.float32
        x = self.item_emb[seqs].to(cd)
        if keep_masks is not None and c.dropout_rate > 0.0:
            (keep,) = keep_masks
            x = apply_dropout(x, keep, c.dropout_rate)
        valid = (seqs != 0).to(cd)[:, :, None]
        hd = c.hidden_dim
        h_seq = x
        with fp32_reduction():
            for layer in range(c.num_layers):
                wx, wh, b = (getattr(self, f"l{layer}_{n}").to(cd) for n in ("wx", "wh", "b"))
                xproj = h_seq @ wx + b  # (B, L, 3h), the whole sequence at once
                h = torch.zeros(seqs.shape[0], hd, dtype=cd, device=seqs.device)
                outs = []
                for t in range(seqs.shape[1]):
                    xp, v = xproj[:, t], valid[:, t]
                    hp = h @ wh
                    r = torch.sigmoid(xp[:, :hd] + hp[:, :hd])
                    z = torch.sigmoid(xp[:, hd:2 * hd] + hp[:, hd:2 * hd])
                    n = torch.tanh(xp[:, 2 * hd:] + r * hp[:, 2 * hd:])
                    h_new = (1 - z) * n + z * h
                    h = v * h_new + (1 - v) * h  # PAD: carry the state
                    outs.append(h)
                h_seq = torch.stack(outs, dim=1)
        return h_seq.float()

    def draw(self, generator: torch.Generator, pos: torch.Tensor):
        """One step's embedding keep mask (None without dropout)."""
        c = self.cfg
        return dropout_masks(generator, (*pos.shape, c.embedding_dim), c.dropout_rate, 1)

    def next_item_bpr_loss(self, seqs, pos, neg, draws=None):
        h = self.encode(seqs, draws) @ self.out_proj
        return next_item_bpr(h, self.item_emb, pos, neg, pos != 0)

    def user_representations(self, seqs: torch.Tensor) -> torch.Tensor:
        return self.encode(seqs)[:, -1, :] @ self.out_proj
