"""XSimGCL, graph contrastive learning on LightGCN propagation (port of
`gsrs_tpu.models.xsimgcl`).

One propagation gives both contrastive views: during training every
layer's output is perturbed, e' = e + ε · sign(e) ⊙ normalize(U(0, 1)),
and an InfoNCE term ties the final layer-mean representation to the
``cl_layer``'th layer's, over the batch's unique users and positive
items. Evaluation runs noiseless, so the eval path is LightGCN's.

The noise is drawn from the step generator (`draw_noise`, on its device)
and handed to `views_from_noise`, which a test can give the uniform
draws JAX makes for the same key. With ``cfg.dropout`` the edge mask is
drawn after the noise; layers run on the model's layout, and the
i2i smoothing through the ELL gather-reduce (`ops.ell.ell_spmm`), as in
the port's LightGCN.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from gsrs_tpu_torch.models.lightgcn import LightGCN
from gsrs_tpu_torch.ops.linalg import l2_normalize

Noise = List[Tuple[torch.Tensor, torch.Tensor]]  # per layer, U(0, 1) draws (n, d) and (m, d)


def info_nce(z1: torch.Tensor, z2: torch.Tensor, temp: float) -> torch.Tensor:
    """Mean InfoNCE over rows: positives are the aligned pairs, negatives
    the rest of the batch."""
    z1, z2 = l2_normalize(z1), l2_normalize(z2)
    logits = (z1 @ z2.T) / temp  # (B, B)
    return -(torch.diagonal(logits) - torch.logsumexp(logits, dim=1)).mean()


def info_nce_unique(
    ids: torch.Tensor, view1: torch.Tensor, view2: torch.Tensor, temp: float
) -> torch.Tensor:
    """InfoNCE over the UNIQUE ids of a batch, as the JAX package computes
    it with static shapes: ids sorted, duplicate rows masked out of the
    numerator and duplicate columns out of the denominator. ``view1`` and
    ``view2`` are full node tables; rows are gathered here."""
    ids_s = torch.sort(ids).values
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=ids.device),
                       ids_s[1:] != ids_s[:-1]])
    z1 = l2_normalize(view1[ids_s])
    z2 = l2_normalize(view2[ids_s])
    logits = (z1 @ z2.T) / temp  # (B, B)
    logits = torch.where(first[None, :], logits, float("-inf"))
    per_row = torch.diagonal(logits) - torch.logsumexp(logits, dim=1)
    count = torch.clamp(first.sum(), min=1)
    return -torch.where(first, per_row, 0.0).sum() / count


class XSimGCL(LightGCN):
    # the trainer hands a step generator even with edge dropout off: the
    # noise views need it
    needs_step_key = True
    # the InfoNCE term couples the batch's rows: every data-axis rank takes the whole batch
    batch_separable = False

    def draw_noise(self, generator: torch.Generator) -> Noise:
        """The U(0, 1) fp32 draws of every layer's perturbation, made on the
        generator's device and moved to the model's (a host generator
        gives every device the same draws)."""
        d, gen_dev, dev = self.cfg.embedding_dim, generator.device, self.user_emb.device
        return [(torch.rand(self.n_users, d, generator=generator, device=gen_dev).to(dev),
                 torch.rand(self.m_items, d, generator=generator, device=gen_dev).to(dev))
                for _ in range(self.cfg.num_layers)]

    def views_from_noise(
        self, dropout_generator: Optional[torch.Generator], noise: Optional[Noise]
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """One propagation → (final_u, final_i, view_u, view_i): the
        layer-mean readout and the ``cl_layer``'th layer, every layer
        perturbed by its ``noise`` entry (None: noiseless, exactly
        LightGCN's propagation)."""
        cfg = self.cfg
        u, i = self._tables()
        layer = self._layer(dropout_generator, u.dtype)

        def perturb(x, r):
            return x + (cfg.cl_eps * torch.sign(x.float()) * l2_normalize(r)).to(x.dtype)

        acc_u, acc_i = u, i
        cur_u, cur_i = u, i
        view_u, view_i = u, i
        cl_layer = min(max(cfg.cl_layer, 1), max(cfg.num_layers, 1))
        for k in range(cfg.num_layers):
            cur_u, cur_i = layer(cur_u, cur_i)
            if noise is not None:
                cur_u, cur_i = perturb(cur_u, noise[k][0]), perturb(cur_i, noise[k][1])
            acc_u = acc_u + cur_u
            acc_i = acc_i + cur_i
            if k + 1 == cl_layer:
                view_u, view_i = cur_u, cur_i
        all_users, all_items = self._readout(acc_u, acc_i)
        return all_users, all_items, view_u.float(), view_i.float()

    def _propagate_views(self, generator: Optional[torch.Generator]):
        """`views_from_noise` with this step's draws from ``generator``
        (the noise, then the edge mask); noiseless without one."""
        if generator is None:
            return self.views_from_noise(None, None)
        return self.views_from_noise(generator, self.draw_noise(generator))

    def propagate(self, dropout_generator: Optional[torch.Generator] = None):
        fu, fi, _, _ = self._propagate_views(dropout_generator)
        return fu, fi

    def bpr_loss(
        self,
        users: torch.Tensor,
        pos: torch.Tensor,
        neg: torch.Tensor,
        dropout_generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """BPR (LightGCN's convention) + cl_lambda · (InfoNCE over the
        batch's unique users and over its unique positives, between the
        two views); the CL term only with a generator (training)."""
        all_u, all_i, view_u, view_i = self._propagate_views(dropout_generator)
        return self.loss_from_views(users, pos, neg, all_u, all_i, view_u, view_i,
                                    cl=dropout_generator is not None)

    def loss_from_views(self, users, pos, neg, all_u, all_i, view_u, view_i, cl: bool = True):
        if self.cfg.use_pop_gate:
            items, gate = self._fuse(all_i)
        else:
            items, gate = all_i, None
        loss, aux = self._pairwise_bpr(all_u, items, gate, users, pos, neg)
        if cl and self.cfg.cl_lambda > 0.0:
            term = (info_nce_unique(users, all_u, view_u, self.cfg.cl_temp)
                    + info_nce_unique(pos, all_i, view_i, self.cfg.cl_temp))
            loss = loss + self.cfg.cl_lambda * term
            aux = {**aux, "cl": term}
        return loss, aux
