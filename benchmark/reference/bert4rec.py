"""Plain BERT4Rec (Sun et al., CIKM 2019, arXiv:1904.06690) in float32
PyTorch: the reference that decides ``correct`` in the BERT4Rec cells.

From the paper's equations, on a vocabulary of PAD = 0, the items 1..m
and MASK = m + 1:

- input (§3.4): h⁰ = v + p, the item and position embeddings summed;
- blocks (Eqs. 1–5): multi-head attention over the non-PAD keys, A =
  LN(H + Dropout(MH(H))), Trm(H) = LN(A + Dropout(PFFN(A))), PFFN(x) =
  GELU(x·W1 + b1)·W2 + b2 with GELU's tanh form (BERT's code);
- output (Eq. 7): P(v) = softmax(GELU(h·W^P + b^P)·Eᵀ + b^O) over the m
  real items, E the item table's rows 1..m (tied);
- loss: each slot's −log P(its item), weighted by the slot's weight,
  Σ w · nll / (Σ w + 1e-5) (the released code's ``masked_lm`` loss);
- update: the gradient clipped to a global norm c (g · min(1, c / (‖g‖ +
  1e-6))), then Adam (β 0.9, 0.999, bias-corrected) with decoupled weight
  decay λ on the matrices and embeddings (p ← p − lr·λ·p before the Adam
  step), at BERT's schedule: lr · t / warmup in the warm-up, then lr ·
  (1 − t / decay_steps), t the steps taken before.

The choices the paper leaves open follow the configuration's
``assumed``, as the program does: dropout on the embedding sum and on the
two sub-layer outputs (the keep masks are given, never drawn here),
LayerNorm with eps 1e-6 and no LayerNorm on the embedding sum or after
the head's GELU, masked attention logits at −1e9. Products run in
float32 with TF32 off. The head's logits are computed in blocks of
``BLOCK`` slots, each block's gradient taken before the next, so the
(slots × items) matrix is never held whole.

``tf32=True`` rounds the inputs of every matrix product, forward and
backward, to TF32's 10 mantissa bits (the control: the precision below
the configuration's, the same on every device). ``slot_share`` < 1 keeps
the slots of that leading share of each batch's sequences (a planted
fault).

It imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from benchmark.reference.lightgcn import matmul_precision, tf32_rounded

BETAS = (0.9, 0.999)
LN_EPS = 1e-6
NEG_LOGIT = -1e9
BLOCK = 2048  # the slots of one block of the head's logits


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every parameter's shape, by the names the configuration's weights
    carry (the program's: ``b{i}_*`` per block)."""
    m, d = cfg["model"], cfg["data"]
    D, F, L = m["embedding_dim"], m["ffn_hidden"], m["max_len"]
    shapes = {"item_emb": (d["m_items"] + 2, D), "pos_emb": (L, D)}
    for b in range(m["num_blocks"]):
        for w in ("wq", "wk", "wv", "wo"):
            shapes[f"b{b}_{w}"] = (D, D)
        shapes.update({f"b{b}_ffn1": (D, F), f"b{b}_ffn1_b": (F,), f"b{b}_ffn2": (F, D),
                       f"b{b}_ffn2_b": (D,)})
        for ln in ("ln1", "ln2"):
            shapes[f"b{b}_{ln}_scale"] = (D,)
            shapes[f"b{b}_{ln}_bias"] = (D,)
    shapes.update({"head_w": (D, D), "head_b": (D,), "out_bias": (d["m_items"],)})
    return shapes


class _TF32Product(torch.autograd.Function):
    """a @ b with the inputs rounded to TF32, and so the two products of
    its backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_rounded(a) @ tf32_rounded(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_rounded(g)
        return g @ tf32_rounded(b).transpose(-1, -2), tf32_rounded(a).transpose(-1, -2) @ g


def _product(tf32: bool):
    return _TF32Product.apply if tf32 else torch.matmul


def layer_norm(x, scale, bias):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * scale + bias


def gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def encode(P: Dict[str, torch.Tensor], tokens: torch.Tensor, keep: Optional[List[torch.Tensor]],
           cfg: dict, tf32: bool = False) -> torch.Tensor:
    """(B, L, d) hidden states of the corrupted ``tokens``; ``keep`` the
    1 + 2·blocks dropout keep masks (None: no dropout)."""
    m = cfg["model"]
    rate, H = m["dropout_rate"], m["num_heads"]
    mm = _product(tf32)
    B, L = tokens.shape
    d = P["pos_emb"].shape[1]
    hd = d // H
    masks = iter(keep or [])

    def dropout(x):
        return x if keep is None else torch.where(next(masks), x / (1.0 - rate), 0.0)

    key_ok = (tokens != 0)[:, None, None, :]
    x = dropout(P["item_emb"][tokens] + P["pos_emb"][None])
    for b in range(m["num_blocks"]):
        def w(name):
            return P[f"b{b}_{name}"]

        def heads(t):
            return t.reshape(B, L, H, hd).transpose(1, 2)

        q, k, v = (heads(mm(x, w(n))) for n in ("wq", "wk", "wv"))
        logits = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
        probs = torch.softmax(torch.where(key_ok, logits, NEG_LOGIT), dim=-1)
        attn = mm(probs, v).transpose(1, 2).reshape(B, L, d)
        x = layer_norm(x + dropout(mm(attn, w("wo"))), w("ln1_scale"), w("ln1_bias"))
        ffn = mm(gelu(mm(x, w("ffn1")) + w("ffn1_b")), w("ffn2")) + w("ffn2_b")
        x = layer_norm(x + dropout(ffn), w("ln2_scale"), w("ln2_bias"))
    return x


def head_logits(P, hs: torch.Tensor, items: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """Eq. 7's logits of slot states ``hs`` (S, d) over ``items`` (E, m × d)."""
    mm = _product(tf32)
    return mm(gelu(mm(hs, P["head_w"]) + P["head_b"]), items.T) + P["out_bias"]


def loss_and_grads(P: Dict[str, torch.Tensor], seqs, corrupted, positions, weights, keep,
                   cfg: dict, tf32: bool = False, slot_share: float = 1.0):
    """The weighted cloze loss of one batch and its gradient by name.
    ``seqs`` (B, L) the uncorrupted sequences (the slots' items),
    ``positions``/``weights`` (B, P) the slots."""
    m_items = cfg["data"]["m_items"]
    B = seqs.shape[0]
    w = weights.float().clone()
    w[max(1, int(B * slot_share)):] = 0.0
    leaves = {k: v.detach().requires_grad_(True) for k, v in P.items()}
    h = encode(leaves, corrupted, keep, cfg, tf32)
    d = h.shape[-1]
    hs = h.gather(1, positions[..., None].expand(-1, -1, d)).reshape(-1, d)
    labels = seqs.gather(1, positions).reshape(-1) - 1
    w = w.reshape(-1)
    total_w = w.sum() + 1e-5
    # the head by blocks of slots: its inputs as leaves of their own
    hs_leaf = hs.detach().requires_grad_(True)
    items = leaves["item_emb"][1:m_items + 1].detach().requires_grad_(True)
    head = {k: leaves[k] for k in ("head_w", "head_b", "out_bias")}
    loss = torch.zeros((), dtype=torch.float64, device=seqs.device)
    for s in range(0, hs.shape[0], BLOCK):
        sl = slice(s, s + BLOCK)
        logits = head_logits(head, hs_leaf[sl], items, tf32)
        y = labels[sl].clamp(min=0)
        nll = torch.logsumexp(logits, dim=1) - logits.gather(1, y[:, None])[:, 0]
        part = (nll * w[sl]).sum() / total_w
        part.backward()
        loss += part.detach().double()
    hs.backward(hs_leaf.grad)
    grads = {k: v.grad if v.grad is not None else torch.zeros_like(v)
             for k, v in leaves.items()}
    grads["item_emb"] = grads["item_emb"].clone()
    grads["item_emb"][1:m_items + 1] += items.grad
    return float(loss), grads


def schedule(t: int, train: dict) -> float:
    """The learning rate of the update after ``t`` steps (BERT's)."""
    lr, warm, total = train["lr"], train["warmup_steps"], train["decay_steps"]
    if t < warm:
        return lr * t / warm
    return lr * (1.0 - min(t, total) / total)


def clipped(g: Dict[str, torch.Tensor], clip_norm: float) -> Dict[str, torch.Tensor]:
    """The gradient scaled to at most ``clip_norm`` in global norm."""
    norm = torch.sqrt(sum((x.double() ** 2).sum() for x in g.values())).float()
    coef = torch.clamp(clip_norm / (norm + 1e-6), max=1.0)
    return {k: x * coef for k, x in g.items()}


@torch.no_grad()
def adamw_step(p, mom, vel, g, t: int, lr: float, train: dict) -> None:
    """Update ``t`` (from 1) of every leaf of ``p`` in place, with its
    moments ``mom`` and ``vel``: decoupled decay of the leaves of two or
    more dimensions, then the bias-corrected Adam step."""
    (b1, b2), eps = BETAS, train["adam_eps"]
    for k in p:
        if p[k].dim() >= 2:
            p[k] = p[k] * (1.0 - lr * train["weight_decay"])
        mom[k] = b1 * mom[k] + (1 - b1) * g[k]
        vel[k] = b2 * vel[k] + (1 - b2) * g[k] * g[k]
        step = (mom[k] / (1 - b1 ** t)) / (torch.sqrt(vel[k] / (1 - b2 ** t)) + eps)
        p[k] = p[k] - lr * step


def train_replay(P0: Dict[str, torch.Tensor], steps: Sequence[dict], cfg: dict,
                 tf32: bool = False, slot_share: float = 1.0, change_after: int = 0,
                 weight_decay: Optional[float] = None) -> Dict[str, object]:
    """Steps from the weights ``P0`` on the given batches and draws (each
    {seqs, corrupted, positions, weights, keep}) → {"loss": each step's
    loss, "grad": the first (clipped) gradient's norm by leaf, "change":
    the norm of each leaf's change over the first ``change_after`` steps
    (0: all), "norm": each leaf's norm after the last step (float64)}.
    ``weight_decay`` in place of the configuration's: a planted fault."""
    t_cfg = dict(cfg["train"])
    if weight_decay is not None:
        t_cfg["weight_decay"] = weight_decay
    p = {k: v.detach().clone() for k, v in P0.items()}
    mom = {k: torch.zeros_like(v) for k, v in p.items()}
    vel = {k: torch.zeros_like(v) for k, v in p.items()}
    out: Dict[str, object] = {"loss": []}
    with matmul_precision(False):
        for t, s in enumerate(steps, start=1):
            loss, g = loss_and_grads(p, s["seqs"], s["corrupted"], s["positions"],
                                     s["weights"], s["keep"], cfg, tf32, slot_share)
            g = clipped(g, t_cfg["clip_norm"])
            out["loss"].append(loss)
            if t == 1:
                out["grad"] = {k: float(x.norm()) for k, x in g.items()}
            adamw_step(p, mom, vel, g, t, schedule(t - 1, t_cfg), t_cfg)
            if t == (change_after or len(steps)):
                out["change"] = {k: float((p[k] - P0[k]).norm()) for k in p}
    out["norm"] = {k: float(v.double().norm()) for k, v in p.items()}
    return out
