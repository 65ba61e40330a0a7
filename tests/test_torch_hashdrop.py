"""The port's stateless hash dropout against the JAX package's: bitwise
equal masks for the same ids and key words (words at and above 2**31
included), in fp32 and bf16, over broadcast shapes; the 32-bit multiply
in int64 against numpy's wrapping uint32 multiply; and the port's key
draw from a torch.Generator."""

import numpy as np
import pytest
import torch

from gsrs_tpu_torch.ops import hashdrop as th

KEYS = [(1, 2), (2**31, 2**31 + 5), (0xFFFFFFFF, 123456789), (3000000000, 0)]


@pytest.fixture
def jh():
    pytest.importorskip("jax", reason="the JAX package is the reference these tests compare with")
    from gsrs_tpu.ops import hashdrop

    return hashdrop


def _jdrop(k0, k1, keep_prob):
    import jax.numpy as jnp

    return (jnp.uint32(k0), jnp.uint32(k1), jnp.float32(keep_prob))


@pytest.mark.parametrize("k0,k1", KEYS)
@pytest.mark.parametrize("keep_prob", [0.6, 0.9])
def test_hash_keep_is_bitwise_the_jax_mask(jh, k0, k1, keep_prob):
    import jax.numpy as jnp

    rng = np.random.default_rng(k0 % 97)
    u = rng.integers(0, 2**31, 5000).astype(np.int32)
    i = rng.integers(0, 2**31, 5000).astype(np.int32)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(jh.hash_keep(jnp.asarray(u), jnp.asarray(i), _jdrop(k0, k1, keep_prob),
                                       dtype=jdtype).astype(jnp.float32))
        got = th.hash_keep(torch.from_numpy(u), torch.from_numpy(i), (k0, k1, keep_prob), dtype)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), want)
    assert 0.5 * keep_prob < float((got > 0).float().mean()) < 1.5 * keep_prob


def test_hash_keep_broadcasts_and_takes_tensor_words(jh):
    """A (rows, 1) × (rows, cols) grid, as the tiled layout's dense cells,
    with the key words as 0-dim int64 tensors (as drawn on the device)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    rows = rng.integers(0, 30000, (64, 1)).astype(np.int32)
    cols = rng.integers(0, 40000, (64, 128)).astype(np.int32)
    k0, k1 = 2**32 - 7, 2**31 + 1
    want = np.asarray(jh.hash_keep(jnp.asarray(rows), jnp.asarray(cols), _jdrop(k0, k1, 0.7)))
    drop = (torch.tensor(k0), torch.tensor(k1), 0.7)
    got = th.hash_keep(torch.from_numpy(rows), torch.from_numpy(cols), drop)
    assert got.shape == (64, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    assert th.canonical_hash_mask(torch.from_numpy(rows), torch.from_numpy(cols), None) is None
    np.testing.assert_array_equal(
        th.canonical_hash_mask(torch.from_numpy(rows), torch.from_numpy(cols), drop).numpy(), want)


def test_mul32_wraps_as_uint32():
    rng = np.random.default_rng(0)
    h = np.concatenate([rng.integers(0, 2**32, 10000, dtype=np.uint64),
                        np.array([0, 1, 2**31, 2**32 - 1], np.uint64)]).astype(np.uint32)
    for c in (0x9E3779B1, 0x85EBCA77, 0x7FEB352D, 0x846CA68B, 0xFFFFFFFF):
        want = h * np.uint32(c)  # numpy wraps uint32 products
        got = th._mul32(torch.from_numpy(h.astype(np.int64)), c)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_hashdrop_from_generator_draws_32_bit_words():
    a = th.hashdrop_from_generator(torch.Generator().manual_seed(5), 0.6)
    b = th.hashdrop_from_generator(torch.Generator().manual_seed(5), 0.6)
    c = th.hashdrop_from_generator(torch.Generator().manual_seed(6), 0.6)
    assert all(0 <= int(w) < 2**32 for w in a[:2]) and a[2] == 0.6
    assert [int(w) for w in a[:2]] == [int(w) for w in b[:2]] != [int(w) for w in c[:2]]
    ids = torch.arange(20000)
    mask = th.hash_keep(ids, ids.flip(0), a)
    assert abs(float((mask > 0).float().mean()) - 0.6) < 0.02
    assert set(mask.unique().tolist()) == {0.0, float(np.float32(1) / np.float32(0.6))}
