"""Shared pre-LN transformer encoder of SASRec and BERT4Rec (port of
`gsrs_tpu.models._transformer`), and BERT4Rec's published post-LN blocks
(``post_ln``).

The two models differ only in the attention mask, the FFN activation and
the vocabulary rows (PAD vs PAD + MASK). Parameters keep the JAX
package's names, shapes and ``(in, out)`` layout: products are ``x @ W``,
so parameters and artifacts pass between the packages untransposed.

Numerics follow JAX's statement for statement:

- LayerNorm with the population variance and eps 1e-6 inside the rsqrt;
  its statistics are computed in fp32 and rounded to x's dtype, as
  ``jnp.mean``/``jnp.var`` round them for bf16 input;
- the attention logits and the attention output are products of bf16
  values summed in fp32 (JAX's ``preferred_element_type=jnp.float32``);
  every other bf16 product is summed in fp32 and rounded once to bf16
  (`fp32_reduction` pins cuBLAS's reduction);
- masked logits are set to −1e9, not −inf: a PAD query whose keys are
  all masked gets a uniform softmax, finite, and its row is zeroed after
  the block;
- the final LayerNorm runs in fp32.

``post_ln`` takes BERT4Rec's published blocks instead (Sun et al., CIKM
2019, Eqs. 4–5): h⁰ = v + p without the √d scale, A = LN(H +
Dropout(MH(H))), Trm(H) = LN(A + Dropout(PFFN(A))), and no final
LayerNorm (its parameters are not drawn: ``final_ln=False``). The
dropout sites are the same three kinds; the released code's dropout of
the attention probabilities is not taken.

Dropout takes its keep masks as an argument (``keep_masks``, one per
dropout site, in JAX's order: the embedding, then per block the attention
and the FFN output), so the draws are made apart from the computation:
`dropout_masks` draws them from a `torch.Generator`, and tests hand the
port the masks JAX draws with ``fold_in(key, i)``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

from gsrs_tpu_torch.ops.gather import gather_rows, gather_rows_cat
from gsrs_tpu_torch.ops.linalg import fp32_reduction

Params = Dict[str, torch.Tensor]
NEG_LOGIT = -1e9


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu.to(x.dtype)) * torch.rsqrt(var.to(x.dtype) + eps) * scale + bias


def init_encoder_params(
    generator: torch.Generator,
    *,
    vocab_rows: int,
    max_len: int,
    d: int,
    num_blocks: int,
    ffn_hidden: int,
    final_ln: bool = True,
) -> Params:
    """Embedding tables N(0, 0.1²), positional rows, the final LayerNorm,
    and per block ``b{i}_*`` attention, FFN and LayerNorm parameters, the
    matrices Glorot-normal (std sqrt(2/(in+out))) in ``(in, out)`` layout:
    CPU tensors drawn from ``generator``, in JAX's key order."""
    g = generator

    def normal(*shape):
        return torch.randn(shape, generator=g)

    def glorot(i, o):
        return normal(i, o) * math.sqrt(2.0 / (i + o))

    params: Params = {
        "item_emb": 0.1 * normal(vocab_rows, d),  # row 0 is PAD
        "pos_emb": 0.1 * normal(max_len, d),
    }
    if final_ln:
        params["ln_f_scale"] = torch.ones(d)
        params["ln_f_bias"] = torch.zeros(d)
    for b in range(num_blocks):
        for w in ("wq", "wk", "wv", "wo"):
            params[f"b{b}_{w}"] = glorot(d, d)
        params[f"b{b}_ffn1"] = glorot(d, ffn_hidden)
        params[f"b{b}_ffn1_b"] = torch.zeros(ffn_hidden)
        params[f"b{b}_ffn2"] = glorot(ffn_hidden, d)
        params[f"b{b}_ffn2_b"] = torch.zeros(d)
        for ln in ("ln1", "ln2"):
            params[f"b{b}_{ln}_scale"] = torch.ones(d)
            params[f"b{b}_{ln}_bias"] = torch.zeros(d)
    return params


def dropout_masks(generator: torch.Generator, shape, rate: float,
                  count: int) -> Optional[List[torch.Tensor]]:
    """``count`` keep masks (bool, True with probability 1 − rate) of
    ``shape`` on the generator's device; None when ``rate`` is 0."""
    if rate == 0.0:
        return None
    return [torch.rand(shape, generator=generator, device=generator.device) < 1.0 - rate
            for _ in range(count)]


def apply_dropout(t: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """JAX's inverted dropout: kept values scaled by 1/(1 − rate) in t's
    dtype, the others 0."""
    return torch.where(keep, t / (1.0 - rate), 0.0).to(t.dtype)


def encode_transformer(
    params: Params,
    seqs: torch.Tensor,  # (B, L) int64, PAD = 0
    attn_mask: torch.Tensor,  # bool, (B, L, L) or (B, 1, L)
    *,
    max_len: int,
    num_blocks: int,
    num_heads: int,
    dropout_rate: float,
    bf16_compute: bool,
    activation: Callable[[torch.Tensor], torch.Tensor],
    keep_masks: Optional[List[torch.Tensor]] = None,
    post_ln: bool = False,
) -> torch.Tensor:
    """→ (B, L, d) fp32 hidden states. ``keep_masks``: 1 + 2·num_blocks
    keep masks of shape (B, L, d), or None for no dropout. ``post_ln``:
    the published BERT4Rec blocks (the module's note)."""
    d = params["pos_emb"].shape[-1]
    cd = torch.bfloat16 if bf16_compute else torch.float32
    masks = iter(keep_masks) if (keep_masks is not None and dropout_rate > 0.0) else None
    if masks is not None and len(keep_masks) != 1 + 2 * num_blocks:
        raise ValueError(f"{len(keep_masks)} keep masks for {1 + 2 * num_blocks} dropout sites")

    def dropout(t):
        return t if masks is None else apply_dropout(t, next(masks), dropout_rate)

    pad_mask = (seqs != 0)[:, :, None]
    x = gather_rows(params["item_emb"], seqs)
    if not post_ln:
        x = x * math.sqrt(d)
    x = x + params["pos_emb"][None, :, :]
    x = dropout(torch.where(pad_mask, x, 0.0).to(cd))
    H = num_heads
    hd = d // H
    mask = attn_mask[:, None]
    with fp32_reduction():
        for b in range(num_blocks):
            def w(name):
                return params[f"b{b}_{name}"].to(cd)

            def ln(t, name):
                return layer_norm(t, params[f"b{b}_{name}_scale"],
                                  params[f"b{b}_{name}_bias"]).to(cd)

            def attention(h):
                q, k, v = ((h @ w(n)).reshape(-1, max_len, H, hd) for n in ("wq", "wk", "wv"))
                logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
                probs = torch.softmax(torch.where(mask, logits, NEG_LOGIT), dim=-1).to(cd)
                attn = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
                return attn.reshape(-1, max_len, d).to(cd) @ w("wo")

            def ffn(h):
                return activation(h @ w("ffn1") + w("ffn1_b")) @ w("ffn2") + w("ffn2_b")

            if post_ln:
                x = ln(x + dropout(attention(x)), "ln1")
                x = ln(x + dropout(ffn(x)), "ln2")
            else:
                x = x + dropout(attention(ln(x, "ln1")))
                x = x + dropout(ffn(ln(x, "ln2")))
            x = torch.where(pad_mask, x, 0.0)
    if post_ln:
        return x.float()
    return layer_norm(x.float(), params["ln_f_scale"], params["ln_f_bias"])


def next_item_bpr(h: torch.Tensor, item_emb: torch.Tensor, pos: torch.Tensor,
                  neg: torch.Tensor, weight: torch.Tensor):
    """The family's pairwise loss: BPR of each position's (pos, neg) pair
    under ``weight`` (B, L), normalized by max(Σ weight, 1), and the L2
    term over every gathered row, PAD rows included, per sequence →
    (bpr, {"bpr", "reg"})."""
    pe, ne = gather_rows_cat(item_emb, pos, neg)
    diff = (h * pe).sum(dim=-1) - (h * ne).sum(dim=-1)
    w = weight.float()
    bpr = -(torch.nn.functional.logsigmoid(diff) * w).sum() / torch.clamp(w.sum(), min=1.0)
    reg = 0.5 * ((pe * pe).sum() + (ne * ne).sum()) / pos.shape[0]
    return bpr, {"bpr": bpr, "reg": reg}
