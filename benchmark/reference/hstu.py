"""Plain HSTU (Zhai et al., "Actions Speak Louder than Words", ICML 2024,
arXiv:2402.17152) in float32 PyTorch: the reference that decides
``correct`` in the HSTU cells.

On sequences of N slots (id 0 = PAD, items 1..m, most recent last) with
each slot's time in seconds; d the width, H heads of width d_h, ``LN``
the LayerNorm (x − mean) / √(var + 1e-6) with no affine terms, SiLU(x) =
x·σ(x):

- input: x⁰_i = Dropout(√d · E[s_i] + P[i]) · 1[s_i ≠ 0];
- each block (Eqs. 1–3): [U, V, Q, K] = Split(SiLU(LN(X) W₁)); per head
  A_h = SiLU(Q_h K_hᵀ + rab) / N ⊙ M, N the padded length, M_ij =
  1[j ≤ i]·1[s_j ≠ 0]; X ← X + Dropout(U ⊙ LN([A_1 V_1, …, A_H V_H]))
  W₂ + b₂;
- rab_ij = p[N − 1 + j − i] + w[b(τ_i − t_j)], one p (2N − 1) and one w
  (129) a block, shared by its heads; b(Δ) = clamp(⌊ln(max(|Δ|, 1)) /
  0.301⌋, 0, 128); t_j the time of slot j's input, τ_i that of the item
  slot i predicts;
- z_i = x^L_i / max(‖x^L_i‖, 1e-6); for rows e of E, ê = e / max(‖e‖,
  1e-6);
- loss: at each slot with a real input and a real target y_i, ℓ_i =
  −log softmax([z_i·ê_y, z_i·ê_n1, …, z_i·ê_nK] / T)₀ over the slot's K
  given negatives, a negative equal to y_i at logit −5·10⁴; the mean over
  those slots;
- update: Adam (β 0.9, 0.98, eps 1e-8, bias-corrected; AdamW at weight
  decay 0) at the constant learning rate, no clipping.

A training step takes the batch's (B, N) ids ``seqs`` and times as the
trainer holds them (unshifted: the targets), and shifts both one slot
right for the input (slot 0's input PAD at time 0): y_i = seqs_i, τ_i =
times_i, s_i = seqs_{i−1}, t_j = times_{j−1}.

Departures from the paper and from the released code (the
configuration's ``assumed``): the sequences are padded on the left, so M
masks PAD keys explicitly and P is indexed by the slot of the padded
layout (the released code runs jagged sequences, indexed from their
start); the products are float32 with TF32 off (the released runs
enable TF32); the dropout keep masks and the negatives are given, never
drawn here. The attention is written out head by head. Every table row
(E's, and the bias's p and w as one-column tables) is read by
``F.embedding``, whose backward on the card sums a row's long runs of ids
(PAD's, a frequent bucket's) in parallel. It imports nothing of the
program under test.

Planted faults and controls, each an argument: ``tf32`` rounds the
inputs of every matrix product, forward and backward, to TF32's 10
mantissa bits; ``slot_share`` < 1 keeps the slots of that leading share
of each batch's sequences in the loss; ``no_time`` drops rab's time
term; ``pad_keys`` leaves PAD keys in M; ``keep_collisions`` leaves a
negative equal to its target at its logit.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference.bert4rec import _product
from benchmark.reference.lightgcn import matmul_precision

NUM_BUCKETS = 128
LN_EPS = 1e-6
L2_EPS = 1e-6
COLLISION = -5e4


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every parameter's shape, by the names the configuration's weights
    carry (the program's: ``b{l}_*`` per block)."""
    m = cfg["model"]
    D, N, W = m["embedding_dim"], m["max_len"], m["num_heads"] * m["head_dim"]
    shapes = {"item_emb": (cfg["data"]["m_items"] + 1, D), "pos_emb": (N, D)}
    for b in range(m["num_blocks"]):
        shapes.update({f"b{b}_uvqk": (D, 4 * W), f"b{b}_o": (W, D), f"b{b}_o_b": (D,),
                       f"b{b}_pos_w": (2 * N - 1,), f"b{b}_ts_w": (NUM_BUCKETS + 1,)})
    return shapes


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def l2_normalized(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.sqrt((x * x).sum(dim=-1, keepdim=True)), min=L2_EPS)


def buckets(t_in: torch.Tensor, t_tgt: torch.Tensor) -> torch.Tensor:
    """(B, N, N) b(τ_i − t_j) of the input times t (B, N) and the target
    times τ (B, N), from the formula in float64."""
    delta = (t_tgt[:, :, None] - t_in[:, None, :]).double()
    b = torch.floor(torch.log(torch.clamp(delta.abs(), min=1.0)) / 0.301)
    return torch.clamp(b, 0, NUM_BUCKETS).long()


def shifted(x: torch.Tensor) -> torch.Tensor:
    """``x`` (B, N) one slot to the right, 0 in slot 0."""
    out = torch.zeros_like(x)
    out[:, 1:] = x[:, :-1]
    return out


def encode(P: Dict[str, torch.Tensor], inp: torch.Tensor, t_in: torch.Tensor,
           t_tgt: torch.Tensor, keep, cfg: dict, tf32: bool = False, pad_keys: bool = False,
           no_time: bool = False) -> torch.Tensor:
    """(B, N, d) x^L of the input ids ``inp`` with input times ``t_in``
    and target times ``t_tgt``; ``keep`` the 1 + blocks keep masks (None:
    no dropout)."""
    m = cfg["model"]
    rate, H, dh = m["dropout_rate"], m["num_heads"], m["head_dim"]
    mm = _product(tf32)
    B, N = inp.shape
    D = P["pos_emb"].shape[1]
    masks = iter(keep or [])

    def dropout(x):
        return x if keep is None else torch.where(next(masks), x / (1.0 - rate), 0.0)

    real = inp != 0
    x = dropout(F.embedding(inp, P["item_emb"]) * math.sqrt(D) + P["pos_emb"][None])
    x = x * real[..., None].float()
    slot = torch.arange(N, device=inp.device)
    rel = (N - 1) + slot[None, :] - slot[:, None]
    key_ok = torch.ones_like(real) if pad_keys else real
    M = ((slot[None, :] <= slot[:, None])[None] & key_ok[:, None, :]).float()
    bk = buckets(t_in, t_tgt)
    for b in range(m["num_blocks"]):
        rab = F.embedding(rel, P[f"b{b}_pos_w"][:, None])[None, ..., 0]
        if not no_time:
            rab = rab + F.embedding(bk, P[f"b{b}_ts_w"][:, None])[..., 0]
        uvqk = silu(mm(layer_norm(x), P[f"b{b}_uvqk"]))
        U, V, Q, K = (uvqk[..., i * H * dh:(i + 1) * H * dh] for i in range(4))
        heads = []
        for h in range(H):
            cols = slice(h * dh, (h + 1) * dh)
            A = silu(mm(Q[..., cols], K[..., cols].transpose(1, 2)) + rab) / N * M
            heads.append(mm(A, V[..., cols]))
        y = dropout(U * layer_norm(torch.cat(heads, dim=-1)))
        x = x + mm(y, P[f"b{b}_o"]) + P[f"b{b}_o_b"]
    return x


def loss_and_grads(P: Dict[str, torch.Tensor], seqs, times, neg, keep, cfg: dict,
                   tf32: bool = False, slot_share: float = 1.0, pad_keys: bool = False,
                   no_time: bool = False, keep_collisions: bool = False):
    """The sampled-softmax loss of one batch and its gradient by name:
    ``seqs``/``times`` (B, N) unshifted (the targets), ``neg`` (B, N, K)."""
    m = cfg["model"]
    B = seqs.shape[0]
    leaves = {k: v.detach().requires_grad_(True) for k, v in P.items()}
    inp = shifted(seqs)
    x = encode(leaves, inp, shifted(times), times, keep, cfg, tf32, pad_keys, no_time)
    z = l2_normalized(x)
    rows = l2_normalized(F.embedding(torch.cat([seqs[..., None], neg], dim=-1),
                                     leaves["item_emb"]))
    logits = _product(tf32)(rows, z[..., None])[..., 0] / m["temperature"]
    if not keep_collisions:
        same = torch.cat([torch.zeros_like(seqs[..., None], dtype=torch.bool),
                          neg == seqs[..., None]], dim=-1)
        logits = torch.where(same, COLLISION, logits)
    nll = torch.logsumexp(logits, dim=-1) - logits[..., 0]
    w = ((seqs != 0) & (inp != 0)).float()
    w[max(1, int(B * slot_share)):] = 0.0
    loss = (nll * w).sum() / w.sum()
    loss.backward()
    grads = {k: v.grad if v.grad is not None else torch.zeros_like(v) for k, v in leaves.items()}
    return float(loss.detach()), grads


@torch.no_grad()
def adam_step(p, mom, vel, g, t: int, train: dict) -> None:
    """Update ``t`` (from 1) of every leaf of ``p`` in place, with its
    moments ``mom`` and ``vel``: the bias-corrected Adam step."""
    (b1, b2), eps, lr = train["adam_betas"], train["adam_eps"], train["lr"]
    for k in p:
        mom[k] = b1 * mom[k] + (1 - b1) * g[k]
        vel[k] = b2 * vel[k] + (1 - b2) * g[k] * g[k]
        step = (mom[k] / (1 - b1 ** t)) / (torch.sqrt(vel[k] / (1 - b2 ** t)) + eps)
        p[k] = p[k] - lr * step


def train_replay(P0: Dict[str, torch.Tensor], steps: Sequence[dict], cfg: dict,
                 moments: Optional[tuple] = None, change_after: int = 0,
                 **fault) -> Dict[str, object]:
    """Steps from the weights ``P0`` on the given batches and draws (each
    {seqs, times, neg, keep}) → {"loss": each step's loss, "grad": the
    first gradient's norm by leaf, "change": the norm of each leaf's
    change over the first ``change_after`` steps (0: all), "state": (the
    parameters, the moments, the steps taken) after the last step}.
    ``moments`` (mom, vel, steps taken) go on from a state that has
    stepped (zeros and 0 without); ``fault``: `loss_and_grads`'s planted
    faults and controls."""
    t_cfg = cfg["train"]
    p = {k: v.detach().clone().float() for k, v in P0.items()}
    if moments is None:
        mom = {k: torch.zeros_like(v) for k, v in p.items()}
        vel = {k: torch.zeros_like(v) for k, v in p.items()}
        t0 = 0
    else:
        mom, vel, t0 = ({k: v.clone() for k, v in moments[0].items()},
                        {k: v.clone() for k, v in moments[1].items()}, moments[2])
    out: Dict[str, object] = {"loss": []}
    with matmul_precision(False):
        for t, s in enumerate(steps, start=1):
            loss, g = loss_and_grads(p, s["seqs"], s["times"], s["neg"], s["keep"], cfg,
                                     **fault)
            out["loss"].append(loss)
            if t == 1:
                out["grad"] = {k: float(x.norm()) for k, x in g.items()}
            adam_step(p, mom, vel, g, t0 + t, t_cfg)
            if t == (change_after or len(steps)):
                out["change"] = {k: float((p[k] - P0[k]).norm()) for k in p}
    out["state"] = (p, mom, vel, t0 + len(steps))
    return out
