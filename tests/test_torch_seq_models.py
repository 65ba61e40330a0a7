"""The port's sequential models (`gsrs_tpu_torch.models.{sasrec,gru4rec,
bert4rec}`) against the JAX package's on JAX-CPU, from the same JAX
parameters (`convert.seq_params_from_jax`) and the same draws (JAX's
dropout keep masks, ``fold_in(key, i)`` for i = 1 … 1 + 2·blocks in the
transformers, one mask in GRU4Rec, and BERT4Rec's cloze corruption,
handed to the port).

Tolerances:
- fp32: rtol = atol = 1e-5 on hidden states, losses, gradients and
  scores (sums of O(1) values in another order).
- bf16: the two packages round at the same points (JAX's casts) but XLA
  may keep elementwise chains in fp32 where torch rounds each op, so each
  package's bf16 result is held to the fp32 result, within
  ``((1 + 2^-8)^R − 1) · mag + 1e-5``: R roundings of at most 2^-8
  relative each on the longest path, of values bounded by ``mag`` (the
  row's largest |value| for hidden states and scores, the leaf's largest
  |gradient| for gradients, |loss| + 1 for the loss). R counts, for a
  transformer, the embedding's cast and dropout (2) and per block 23
  (the two LayerNorms' 5 each, the q/k/v, probability, attention, Wo,
  FFN1 and FFN2 roundings, both biases, the activation, both dropouts,
  both residual sums): 2 + 23·blocks forward; for GRU4Rec the cast and
  dropout (2) and per layer the input projection and bias (2) and one
  step's 16 (the state is a convex combination of the last state and the
  candidate, so a carried error does not grow): 2 + 18·layers forward.
  Gradients count the forward and the backward, 2R. The port's bf16
  result must also differ from its fp32 result, so that the bf16 path is
  really taken. The bf16 checks run at one block, the fp32 ones at two.
"""

import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="the JAX package is the reference these tests compare with")

import jax
import jax.numpy as jnp

from gsrs_tpu.models.registry import build_seq_model as jbuild
from gsrs_tpu_torch.convert import seq_params_from_jax
from gsrs_tpu_torch.models import _transformer, bert4rec
from gsrs_tpu_torch.models.bert4rec import ClozeDraws
from gsrs_tpu_torch.models.registry import SEQ_MODELS, build_seq_model, seq_model_meta
from gsrs_tpu_torch.models.sasrec import make_training_arrays

M, L, D, HID, BLOCKS, RATE = 40, 10, 16, 24, 2, 0.2
BF16_BLOCKS = 1  # the bf16 checks at one block: JAX compiles half the graph
RTOL = ATOL = 1e-5


def heads(kind):
    return 1 if kind == "gru4rec" else 2


def roundings(kind, blocks=BF16_BLOCKS):
    return 2 + 18 * blocks if kind == "gru4rec" else 2 + 23 * blocks


def bf16_limit(mag, r):
    return ((1 + 2.0**-8) ** r - 1) * mag + 1e-5


@functools.lru_cache(maxsize=None)
def jax_side(kind, bf16, seed, dropout, blocks=BLOCKS):
    """(JAX model, its params, jitted encode, user_representations,
    score_catalog), once per configuration."""
    jm = jbuild(kind, M, max_len=L, dim=D, hidden=HID, blocks=blocks, heads=heads(kind),
                dropout=dropout, bf16=bf16)
    params = jm.init_params(jax.random.key(seed))
    return (jm, params, jax.jit(jm.encode), jax.jit(jm.user_representations),
            jax.jit(jm.score_catalog))


def pair(kind, bf16=False, seed=3, dropout=RATE, blocks=BLOCKS):
    """(JAX model, JAX params, port model with the same parameters)."""
    kw = dict(max_len=L, dim=D, hidden=HID, blocks=blocks, heads=heads(kind), dropout=dropout,
              bf16=bf16)
    jm, params = jax_side(kind, bf16, seed, dropout, blocks)[:2]
    tm = build_seq_model(kind, M, device="cpu", **kw)
    tm.load_state_dict(seq_params_from_jax({k: np.asarray(v) for k, v in params.items()},
                                           kind, "cpu"))
    return jm, params, tm


def batch(seed=0, B=6):
    """(B, L) sequences: PAD prefixes of several lengths, one all-PAD row
    and one row with no PAD."""
    rng = np.random.default_rng(seed)
    s = rng.integers(1, M + 1, (B, L))
    s[0, :4] = 0
    s[1, :L - 1] = 0
    s[2, :] = 0
    s[3, :2] = 0
    return s


def jax_keep_masks(kind, key, B, blocks=BLOCKS):
    shape = (B, L, D)
    if kind == "gru4rec":
        return [np.asarray(jax.random.bernoulli(key, 1 - RATE, shape))]
    return [np.asarray(jax.random.bernoulli(jax.random.fold_in(key, i), 1 - RATE, shape))
            for i in range(1, 2 + 2 * blocks)]


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def within_bf16(got, want, mag, r, what):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    lim = bf16_limit(np.asarray(mag, np.float64), r)
    assert (err <= lim).all(), f"{what}: max error {err.max()} over its limit by " \
                               f"{(err - lim).max()}"


def row_mag(h):
    return np.abs(np.asarray(h)).max(axis=-1, keepdims=True)


# ------------------------------------------------------------------ encode


@pytest.mark.parametrize("dropout", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("kind", SEQ_MODELS)
def test_encode_matches_jax_fp32(kind, dropout):
    jm, params, tm = pair(kind)
    s = batch()
    key = jax.random.key(11)
    want = jax_side(kind, False, 3, RATE)[2](params, jnp.asarray(s, jnp.int32),
                                             key if dropout else None)
    keep = [t(k) for k in jax_keep_masks(kind, key, len(s))] if dropout else None
    with torch.no_grad():
        got = tm.encode(t(s), keep)
    assert np.isfinite(got.numpy()).all()
    close(got, want, f"{kind} encode")


@pytest.mark.parametrize("dropout", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("kind", SEQ_MODELS)
def test_encode_bf16_within_rounding_limit(kind, dropout):
    jm, params, tm = pair(kind, bf16=True, blocks=BF16_BLOCKS)
    _, _, tm32 = pair(kind, blocks=BF16_BLOCKS)
    s = batch()
    key = jax.random.key(11)
    want = np.asarray(jax_side(kind, True, 3, RATE, BF16_BLOCKS)[2](
        params, jnp.asarray(s, jnp.int32), key if dropout else None))
    keep = ([t(k) for k in jax_keep_masks(kind, key, len(s), BF16_BLOCKS)] if dropout
            else None)
    with torch.no_grad():
        got = tm.encode(t(s), keep).numpy()
        ref = tm32.encode(t(s), keep).numpy()
    assert got.dtype == np.float32  # the final LayerNorm (GRU4Rec: the output) is fp32
    r = roundings(kind)
    within_bf16(got, ref, row_mag(ref), r, f"{kind} port bf16 vs fp32")
    within_bf16(want, ref, row_mag(ref), r, f"{kind} JAX bf16 vs fp32")
    assert np.abs(got - ref).max() > 2.0**-9 * np.abs(ref).max() / 8, "no bf16 rounding seen"


# -------------------------------------------------------- loss and gradients


def jax_loss_and_grads(jm, params, inp, pos, neg, key, decay=0.01):
    def total(p):
        loss, aux = jm.next_item_bpr_loss(p, jnp.asarray(inp, jnp.int32),
                                          jnp.asarray(pos, jnp.int32),
                                          jnp.asarray(neg, jnp.int32), key)
        return loss + decay * aux["reg"], aux

    (val, aux), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(params)
    return float(val), float(aux["reg"]), {k: np.asarray(v) for k, v in grads.items()}


def port_draws(jm, kind, key, pos, blocks=BLOCKS):
    """JAX's draws of one step, as the port's loss takes them."""
    if kind != "bert4rec":
        return [t(k) for k in jax_keep_masks(kind, key, len(pos), blocks)]
    k_mask, k_drop = jax.random.split(key)
    corrupted, masked = jm.cloze_mask(k_mask, jnp.asarray(pos, jnp.int32))
    keep = [t(k) for k in jax_keep_masks(kind, k_drop, len(pos), blocks)]
    return ClozeDraws(t(corrupted).long(), t(masked), keep)


def port_loss_and_grads(tm, inp, pos, neg, draws, decay=0.01):
    tm.zero_grad()
    loss, aux = tm.next_item_bpr_loss(t(inp), t(pos), t(neg), draws)
    total = loss + decay * aux["reg"]
    total.backward()
    return (float(total.detach()), float(aux["reg"].detach()),
            {k: p.grad.numpy().copy() for k, p in tm.named_parameters()})


def step_inputs(seed=0):
    pos = batch(seed)
    inp, _, neg = make_training_arrays(pos, M, np.random.default_rng(seed + 1))
    return inp, pos, neg


@pytest.mark.parametrize("kind", SEQ_MODELS)
def test_loss_and_every_gradient_match_jax_fp32(kind):
    jm, params, tm = pair(kind)
    inp, pos, neg = step_inputs()
    key = jax.random.key(7)
    want, want_reg, want_g = jax_loss_and_grads(jm, params, inp, pos, neg, key)
    got, got_reg, got_g = port_loss_and_grads(tm, inp, pos, neg, port_draws(jm, kind, key, pos))
    close(got, want, "loss")
    close(got_reg, want_reg, "reg")
    assert set(got_g) == set(want_g)
    for k in want_g:
        close(got_g[k], want_g[k], f"{kind} gradient of {k}")


@pytest.mark.parametrize("kind", SEQ_MODELS)
def test_loss_and_every_gradient_bf16_within_rounding_limit(kind):
    jm, params, tm = pair(kind, bf16=True, blocks=BF16_BLOCKS)
    _, _, tm32 = pair(kind, blocks=BF16_BLOCKS)
    inp, pos, neg = step_inputs()
    key = jax.random.key(7)
    draws = port_draws(jm, kind, key, pos, BF16_BLOCKS)
    want, _, want_g = jax_loss_and_grads(jm, params, inp, pos, neg, key)
    got, _, got_g = port_loss_and_grads(tm, inp, pos, neg, draws)
    ref, _, ref_g = port_loss_and_grads(tm32, inp, pos, neg, draws)
    r = roundings(kind)
    within_bf16(got, ref, abs(ref) + 1, r, f"{kind} port bf16 loss")
    within_bf16(want, ref, abs(ref) + 1, r, f"{kind} JAX bf16 loss")
    for k in ref_g:
        mag = np.abs(ref_g[k]).max()
        within_bf16(got_g[k], ref_g[k], mag, 2 * r, f"{kind} port bf16 gradient of {k}")
        within_bf16(want_g[k], ref_g[k], mag, 2 * r, f"{kind} JAX bf16 gradient of {k}")
    assert max(np.abs(got_g[k] - ref_g[k]).max() for k in ref_g) > 0, "no bf16 rounding seen"


def test_bert4rec_loss_needs_its_draws():
    _, _, tm = pair("bert4rec")
    inp, pos, neg = step_inputs()
    with pytest.raises(ValueError, match="cloze"):
        tm.next_item_bpr_loss(t(inp), t(pos), t(neg))


def test_pad_bookkeeping_matches_jax():
    """reg counts item_emb[0] at PAD positions and all-PAD rows; the
    negatives are 0 where the positive is; the BPR term is normalized by
    the valid positions. With only PAD rows the BPR term is 0 and reg is
    the PAD row's squared norm · L (positive and negative)."""
    jm, params, tm = pair("sasrec", dropout=0.0)
    pos = np.zeros((3, L), np.int64)
    inp, _, neg = make_training_arrays(pos, M, np.random.default_rng(0))
    assert (neg == 0).all()
    want, want_reg, _ = jax_loss_and_grads(jm, params, inp, pos, neg, None, decay=1.0)
    got, got_reg, _ = port_loss_and_grads(tm, inp, pos, neg, None, decay=1.0)
    pad_sq = float((np.asarray(params["item_emb"][0]) ** 2).sum())
    close(got_reg, pad_sq * L, "reg of PAD rows")
    close(got, want, "loss")
    close(got_reg, want_reg, "reg")


# ------------------------------------------------------ retrieval surfaces


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", SEQ_MODELS)
def test_user_representations_and_scores_match_jax(kind, bf16):
    blocks = BF16_BLOCKS if bf16 else BLOCKS
    jm, params, tm = pair(kind, bf16=bf16, blocks=blocks)
    s = jnp.asarray(batch(5), jnp.int32)
    _, _, _, reps, scores = jax_side(kind, bf16, 3, RATE, blocks)
    want_q = np.asarray(reps(params, s))
    want_s = np.asarray(scores(params, s))
    with torch.no_grad():
        got_q = tm.user_representations(t(s).long()).numpy()
        got_s = tm.score_catalog(t(s).long()).numpy()
    assert got_s.shape == (6, M) and got_s.dtype == np.float32
    assert tm.catalog().is_contiguous() and tm.catalog().shape == (M, D)
    if not bf16:
        close(got_q, want_q, "user representations")
        close(got_s, want_s, "scores")
        return
    _, _, tm32 = pair(kind, blocks=blocks)
    with torch.no_grad():
        ref = tm32.score_catalog(t(s).long()).numpy()
    r = roundings(kind)
    within_bf16(got_s, ref, row_mag(ref), r, f"{kind} port bf16 scores")
    within_bf16(want_s, ref, row_mag(ref), r, f"{kind} JAX bf16 scores")


def test_seq_model_meta_matches_jax():
    for kind in SEQ_MODELS:
        jm, _, tm = pair(kind)
        from gsrs_tpu.models.registry import seq_model_meta as jmeta

        assert seq_model_meta(tm) == jmeta(jm)


def test_init_draws_jax_shapes_and_scales():
    """The port draws its own parameters (a torch generator): JAX's names
    and shapes, N(0, 0.1²) tables, Glorot-normal matrices
    (std sqrt(2/(in+out))), unit LayerNorm scales and zero biases."""
    for kind in SEQ_MODELS:
        tm = build_seq_model(kind, 500, max_len=L, dim=64, hidden=64, blocks=BLOCKS,
                             device="cpu", generator=torch.Generator().manual_seed(1))
        jfull = jbuild(kind, 500, max_len=L, dim=64, hidden=64, blocks=BLOCKS)
        shapes = jax.eval_shape(jfull.init_params, jax.random.key(1))
        got = {k: v.detach().numpy() for k, v in tm.named_parameters()}
        assert sorted(got) == sorted(shapes)
        for k, v in shapes.items():
            a = got[k]
            assert a.shape == v.shape, k
            if k in ("item_emb", "pos_emb"):
                want_std = 0.1
            elif a.ndim == 2:
                want_std = np.sqrt(2.0 / sum(a.shape))
            else:
                want = 1.0 if k.endswith("_scale") else 0.0
                np.testing.assert_array_equal(a, want, err_msg=k)
                continue
            np.testing.assert_allclose(a.std(), want_std, rtol=0.1, err_msg=k)
            assert abs(a.mean()) < 4 * want_std / np.sqrt(a.size), k


# --------------------------------------------------- invariants (JAX's tests)


def test_sasrec_encoder_causality():
    _, _, tm = pair("sasrec")
    seq = torch.arange(1, L + 1)[None]
    seq2 = seq.clone()
    seq2[0, 6] = M - 1
    with torch.no_grad():
        h1, h2 = tm.encode(seq), tm.encode(seq2)
    np.testing.assert_allclose(h1[0, :6].numpy(), h2[0, :6].numpy(), atol=1e-5)
    assert (h1[0, 6] - h2[0, 6]).abs().max() > 1e-4


def test_sasrec_key_masking_ignores_pad_keys():
    """Real positions at the same slots give the same outputs whatever the
    PAD prefix holds; a changed last item changes only the last slot."""
    _, _, tm = pair("sasrec", dropout=0.0)
    a = torch.tensor([[0] * (L - 4) + [1, 2, 3, 4]])
    b = torch.tensor([[0] * (L - 4) + [1, 2, 3, 9]])
    with torch.no_grad():
        ha, hb = tm.encode(a), tm.encode(b)
    np.testing.assert_allclose(ha[0, :L - 1].numpy(), hb[0, :L - 1].numpy(), atol=1e-6)
    assert (ha[0, L - 1] - hb[0, L - 1]).abs().max() > 1e-4


def test_gru4rec_padding_carries_state():
    """The same items after PAD prefixes of different lengths reach the
    same final state (a shorter max_len, the same parameters)."""
    _, params, tm = pair("gru4rec")
    short = build_seq_model("gru4rec", M, max_len=6, dim=D, hidden=HID, blocks=BLOCKS,
                            device="cpu")
    short.load_state_dict(tm.state_dict())
    with torch.no_grad():
        qa = tm.user_representations(torch.tensor([[0] * (L - 4) + [1, 2, 3, 4]]))
        qb = short.user_representations(torch.tensor([[0, 0, 1, 2, 3, 4]]))
    np.testing.assert_allclose(qa.numpy(), qb.numpy(), atol=1e-5)


def test_bert4rec_is_bidirectional():
    _, _, tm = pair("bert4rec")
    seq = torch.arange(1, L + 1)[None]
    seq2 = seq.clone()
    seq2[0, 6] = M - 1
    with torch.no_grad():
        h1, h2 = tm.encode(seq), tm.encode(seq2)
    assert (h1[0, :6] - h2[0, :6]).abs().max() > 1e-4


def test_bert4rec_cloze_mask_properties_and_jax_draws():
    """From JAX's two draws (positions, last-only) the port's corruption
    equals JAX's `cloze_mask`; drawn from a torch generator it keeps
    JAX's properties: PAD never masked, every sequence with a real item
    masks at least one position (the last, forced), masked positions hold
    MASK, the others are untouched."""
    jm, _, tm = pair("bert4rec")
    seqs = batch(2, B=64)
    key = jax.random.key(5)
    want_c, want_m = jm.cloze_mask(key, jnp.asarray(seqs, jnp.int32))
    k_pos, k_last = jax.random.split(key)
    position = jax.random.bernoulli(k_pos, tm.cfg.mask_prob, seqs.shape)
    last_only = jax.random.bernoulli(k_last, tm.cfg.last_only_prob, (len(seqs),))
    got_c, got_m = tm.cloze_from_draws(t(seqs), t(position), t(last_only))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))

    c, m = tm.cloze_mask(torch.Generator().manual_seed(0), t(seqs))
    c, m = c.numpy(), m.numpy()
    assert not m[seqs == 0].any()
    real = (seqs != 0).any(axis=1)
    assert m[real].any(axis=1).all()
    assert (c[m] == tm.cfg.mask_token).all()
    np.testing.assert_array_equal(c[~m], seqs[~m])
    # last-only samples: exactly the final position
    assert ((m.sum(axis=1) == 1) & m[:, -1]).sum() > 0


def test_bert4rec_query_appends_mask_and_scores_finite():
    _, params, tm = pair("bert4rec")
    s = jnp.asarray([[0, 0, 0, 0, 0, 0, 1, 2, 3, 4]], jnp.int32)
    want = np.asarray(jax_side("bert4rec", False, 3, RATE)[4](params, s))
    with torch.no_grad():
        got = tm.score_catalog(t(s).long()).numpy()
    assert got.shape == (1, M) and np.isfinite(got).all()
    close(got, want, "scores")


def test_gelu_is_jax_tanh_form():
    """`jax.nn.gelu` defaults to the tanh approximation; torch's default
    is the exact erf form, which differs by up to ~5e-4: the port's BERT4Rec
    with the erf form fails the 1e-5 encode parity."""
    x = np.linspace(-6, 6, 2001, dtype=np.float32)
    close(bert4rec.gelu_tanh(t(x)), jax.nn.gelu(jnp.asarray(x)), "gelu")
    assert np.abs(torch.nn.functional.gelu(t(x)).numpy() - np.asarray(jax.nn.gelu(x))).max() > 1e-4

    _, params, tm = pair("bert4rec")
    s = batch()
    want = np.asarray(jax_side("bert4rec", False, 3, RATE)[2](params, jnp.asarray(s, jnp.int32)))
    original = bert4rec.gelu_tanh
    try:
        bert4rec.gelu_tanh = torch.nn.functional.gelu
        with torch.no_grad():
            wrong = tm.encode(t(s)).numpy()
    finally:
        bert4rec.gelu_tanh = original
    assert np.abs(wrong - want).max() > ATOL + RTOL * np.abs(want).max()


@pytest.mark.parametrize("kind", ["sasrec", "bert4rec"])
def test_fully_masked_pad_row_is_finite_in_both(kind):
    """An all-PAD row masks every key: under the −1e9 fill its softmax is
    uniform and finite (a −inf fill gives NaN), and the row is zeroed
    after each block, in both packages."""
    assert _transformer.NEG_LOGIT == -1e9
    _, params, tm = pair(kind)
    s = np.zeros((2, L), np.int64)
    s[1, -3:] = [4, 5, 6]
    want = np.asarray(jax_side(kind, False, 3, RATE)[2](params, jnp.asarray(s, jnp.int32)))
    with torch.no_grad():
        got = tm.encode(t(s)).numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    close(got, want, "encode")
    logits = torch.full((1, L), -float("inf"))
    assert torch.isnan(torch.softmax(logits, dim=-1)).all()  # why the fill is finite
