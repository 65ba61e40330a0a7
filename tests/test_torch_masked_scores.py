"""Masked scoring: the plain PyTorch version against the JAX Pallas
kernels in interpret mode, on the cases of tests/test_pallas_kernels.py,
and (marked ``gpu``, on a CUDA card only) the hand-written CUDA kernel
against the plain version."""

import numpy as np
import pytest
import torch

from gsrs_tpu_torch.ops import scoring
from gsrs_tpu_torch.ops.bitset import build_bitset
from gsrs_tpu_torch.ops.scoring import (
    NEG_INF,
    bitplane_permutation,
    masked_scores,
    masked_scores_reference,
    resolve_bitplane_scoring,
)

ATOL = 1e-4  # fp32 dot products summed in another order


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _int32(words):
    return _t(np.ascontiguousarray(words, dtype=np.uint32).view(np.int32))


def _check(got, expect):
    """Identical mask positions (exactly −1e9 in both), scores within ATOL."""
    got, expect = np.asarray(got), np.asarray(expect)
    assert got.shape == expect.shape
    neg = np.float32(NEG_INF)
    np.testing.assert_array_equal(got == neg, expect == neg)
    np.testing.assert_allclose(got, expect, atol=ATOL)


@pytest.fixture
def pk():
    """The JAX Pallas kernels, imported here so that the card-only tests
    below also run where JAX is not installed."""
    pytest.importorskip("jax", reason="the JAX package is the reference these tests compare with")
    from gsrs_tpu.ops import pallas_kernels

    return pallas_kernels


def _natural_cases(rng, tiny_data):
    """(u, it, bits, block_b, block_m) — tiny_data bitset, word padding,
    ragged batch, nothing masked."""
    m, d = tiny_data.m_items, 16
    bits = build_bitset(tiny_data.train_users, tiny_data.train_items, tiny_data.n_users, m)[:8]
    yield (rng.standard_normal((8, d)), rng.standard_normal((m, d)), bits, 8, 64)
    rows = np.zeros((8, 4), np.uint32)
    rows[0, 0] = 1
    yield (rng.standard_normal((8, 8)), rng.standard_normal((100, 8)), rows, 8, 256)
    rows = np.zeros((13, 2), np.uint32)
    rows[0, 0] = 1
    yield (rng.standard_normal((13, 8)), rng.standard_normal((64, 8)), rows, 8, 64)
    yield (rng.standard_normal((8, 8)), rng.standard_normal((64, 8)),
           np.zeros((8, 2), np.uint32), 8, 64)


@pytest.mark.parametrize("case", ["tiny_data", "word_padding", "ragged_batch", "nothing_masked"])
def test_reference_matches_pallas_natural(rng, tiny_data, case, pk):
    import jax.numpy as jnp

    cases = dict(zip(["tiny_data", "word_padding", "ragged_batch", "nothing_masked"],
                     _natural_cases(rng, tiny_data)))
    u, it, bits, block_b, block_m = cases[case]
    u, it = u.astype(np.float32), it.astype(np.float32)
    expect = pk.masked_scores_pallas(jnp.asarray(u), jnp.asarray(it), jnp.asarray(bits),
                                     block_b=block_b, block_m=block_m, interpret=True)
    got = masked_scores_reference(_t(u), _t(it), _int32(bits))
    _check(got, expect)
    assert got.shape == (u.shape[0], it.shape[0])
    # on CPU tensors the wrapper is the plain version
    np.testing.assert_array_equal(masked_scores(_t(u), _t(it), _int32(bits)).numpy(),
                                  got.numpy())


def test_reference_matches_pallas_bitplane(rng, pk):
    import jax.numpy as jnp

    B, m, d, block_m = 8, 5000, 8, 4096
    m_pad = -(-m // block_m) * block_m
    u = rng.standard_normal((B, d)).astype(np.float32)
    it = np.zeros((m_pad, d), np.float32)
    it[:m] = rng.standard_normal((m, d))
    rows = rng.integers(0, 2**32, (B, m_pad // 32), dtype=np.uint64).astype(np.uint32)
    rows[:, m // 32] |= np.uint32(0xFFFFFFFF) << np.uint32(m % 32)
    rows[:, m // 32 + 1:] = np.uint32(0xFFFFFFFF)
    perm = bitplane_permutation(m_pad, block_m)
    expect = pk.masked_scores_bitplane_pallas(jnp.asarray(u), jnp.asarray(it[perm]),
                                              jnp.asarray(rows), block_b=8,
                                              block_m=block_m, interpret=True)
    got = masked_scores(_t(u), _t(it[perm]), _int32(rows), bitplane=True, block_m=block_m)
    assert got.shape == (B, m_pad)
    _check(got, expect)
    # mapped back through the permutation it is the natural layout
    natural = masked_scores_reference(_t(u), _t(it), _int32(rows)).numpy()
    np.testing.assert_array_equal(got.numpy(), natural[:, perm])


@pytest.mark.parametrize("m_pad,block_m", [(8192, 4096), (4096, 4096), (256, 64)])
def test_bitplane_permutation_matches_jax(m_pad, block_m, pk):
    perm = bitplane_permutation(m_pad, block_m)
    np.testing.assert_array_equal(perm, pk.bitplane_permutation(m_pad, block_m))
    np.testing.assert_array_equal(np.sort(perm), np.arange(m_pad))


@pytest.mark.parametrize("mode,want", [
    (True, True), ("on", True), (False, False), ("off", False), ("auto", False),
])
def test_resolve_bitplane_scoring(mode, want):
    assert resolve_bitplane_scoring(mode, 10**6) is want


def test_topk_helpers_match_jax(rng, tiny_data, pk):
    import jax.numpy as jnp

    from gsrs_tpu.ops import topk as jtopk
    from gsrs_tpu_torch.ops import topk as ttopk

    m = tiny_data.m_items
    u = rng.standard_normal((12, 8)).astype(np.float32)
    it = rng.standard_normal((m, 8)).astype(np.float32)
    bits = build_bitset(tiny_data.train_users, tiny_data.train_items, tiny_data.n_users, m)[:12]
    raw = ttopk.score_users(_t(u), _t(it))
    np.testing.assert_allclose(raw.numpy(), np.asarray(jtopk.score_users(u, it)), atol=ATOL)
    _check(ttopk.mask_train_positives(raw, _int32(bits), m),
           jtopk.mask_train_positives(jnp.asarray(u @ it.T), jnp.asarray(bits), m))
    vals, ids = ttopk.masked_topk(_t(u), _t(it), _int32(bits), 10)
    jvals, jids = jtopk.masked_topk(jnp.asarray(u), jnp.asarray(it), jnp.asarray(bits), 10)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), atol=ATOL)
    # approx at m ≤ 128 is one lane tile: no fold, the exact top-k, as JAX's
    for method in ("approx", "threshold"):
        v, i = ttopk.topk_scores(raw, 5, method=method)
        jv, ji = jtopk.topk_scores(jnp.asarray(u @ it.T), 5, method=method)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=ATOL)


def test_resolve_bitplane_scoring_rejects_unknown_modes():
    with pytest.raises(ValueError):
        resolve_bitplane_scoring("fast", 100)


def test_wrapper_raises_instead_of_falling_back():
    u, it = torch.zeros(4, 8), torch.zeros(40, 8)
    with pytest.raises(ValueError, match="bitset width"):
        masked_scores(u, it, torch.zeros(4, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="bit-plane"):
        masked_scores(u, it, torch.zeros(4, 2, dtype=torch.int32), bitplane=True)
    meta = torch.zeros(4, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="different devices"):
        masked_scores(u, it, meta)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        masked_scores(u.to("meta"), it.to("meta"), meta)


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("B,d,m", [
    (256, 64, 40981), (13, 64, 40981), (256, 64, 100), (1, 64, 31), (70, 40, 4096),
    (2048, 64, 40981), (1, 40, 40981), (129, 33, 1001),
])
@pytest.mark.parametrize("bitplane", [False, True])
def test_kernel_matches_reference_on_the_card(cuda, B, d, m, bitplane):
    g = torch.Generator(device=cuda).manual_seed(B * 7 + m)
    block_m = 4096
    rows = -(-m // block_m) * block_m if bitplane else m
    W = rows // 32 if bitplane else -(-m // 32)
    u = torch.randn(B, d, device=cuda, generator=g)
    it = torch.randn(rows, d, device=cuda, generator=g)
    bits = torch.randint(-2**31, 2**31, (B, W), device=cuda, generator=g,
                         dtype=torch.int64).to(torch.int32)
    name = "masked_scores_bitplane" if bitplane else "masked_scores"
    before = scoring.LAUNCHES[name]
    got = masked_scores(u, it, bits, bitplane=bitplane, block_m=block_m)
    torch.cuda.synchronize()
    assert scoring.LAUNCHES[name] == before + 1
    _check(got.cpu(), masked_scores_reference(u, it, bits, bitplane, block_m).cpu())


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    u, it = torch.randn(4, 8, device=cuda), torch.randn(40, 8, device=cuda)
    bits = torch.zeros(4, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        masked_scores(u.double(), it.double(), bits)
    with pytest.raises(TypeError):
        masked_scores(u, it, bits.long())
    with pytest.raises(ValueError, match="contiguous"):
        masked_scores(u, torch.randn(8, 40, device=cuda).T, bits)


@pytest.mark.gpu
@pytest.mark.parametrize("block_m", [64, 8192])
@pytest.mark.parametrize("B", [13, 2048])
def test_kernel_bitplane_block_sizes_on_the_card(cuda, B, block_m):
    """Bit-plane tiles narrower than the kernel's 128 columns (the tile
    index changes inside a block) and wider ones."""
    m_pad = -(-40981 // block_m) * block_m
    g = torch.Generator(device=cuda).manual_seed(block_m + B)
    u = torch.randn(B, 64, device=cuda, generator=g)
    it = torch.randn(m_pad, 64, device=cuda, generator=g)
    bits = torch.randint(-2**31, 2**31, (B, m_pad // 32), device=cuda, generator=g,
                         dtype=torch.int64).to(torch.int32)
    got = masked_scores(u, it, bits, bitplane=True, block_m=block_m)
    torch.cuda.synchronize()
    _check(got.cpu(), masked_scores_reference(u, it, bits, True, block_m).cpu())


@pytest.mark.gpu
def test_kernel_unaligned_rows_on_the_card(cuda):
    """Inputs that start 4 bytes past a 16-byte boundary take the 4-byte
    copies; the scores are the same function."""
    g = torch.Generator(device=cuda).manual_seed(5)
    B, d, m = 37, 64, 3001
    u = torch.randn(B * d + 1, device=cuda, generator=g)[1:].view(B, d)
    it = torch.randn(m * d + 1, device=cuda, generator=g)[1:].view(m, d)
    bits = torch.randint(-2**31, 2**31, (B, -(-m // 32)), device=cuda, generator=g,
                         dtype=torch.int64).to(torch.int32)
    got = masked_scores(u, it, bits)
    torch.cuda.synchronize()
    _check(got.cpu(), masked_scores_reference(u, it, bits).cpu())
