"""The port's ELL layer in bf16 against the JAX package's in bf16:
forward outputs and the VJP for the same cotangents, with and without an
edge mask, on the power-law graph and on the graph with a split mega row
that tests/test_torch_ell_grad.py uses. Both packages cast the masked weights
to bf16 before the product, sum in fp32 and round once per bucket output
(and once more where a mega row's chunks are added back), so they may
differ only where the two fp32 sums round to neighbouring bf16 values:
the tolerance is one bf16 ulp relative (2^-8) plus 1e-6."""

import numpy as np
import pytest
import torch

from gsrs_tpu_torch.data import adjacency as tadj
from gsrs_tpu_torch.data import synthetic as tsyn
from gsrs_tpu_torch.ops import ell as tell

RTOL, ATOL = 2.0**-8, 1e-6


@pytest.fixture
def jax_ell():
    pytest.importorskip("jax", reason="the JAX package is the reference these tests compare with")
    from gsrs_tpu.ops import ell

    return ell


def _graphs(case, jell):
    """(port graph, JAX graph, n, m, E): a power-law graph, or one where
    every user also rated item 17, whose row (200 wide) is split at 8."""
    n, m = 200, 300
    d = tsyn.powerlaw(n, m, seed=5)
    pairs = np.stack([d.train_users, d.train_items], 1)
    if case == "mega_row":
        pairs = np.unique(np.concatenate([pairs, np.stack([np.arange(n), np.full(n, 17)], 1)]),
                          axis=0)
    users, items = pairs[:, 0], pairs[:, 1]
    w = tadj.normalized_edge_weights(users, items, np.bincount(users, minlength=n),
                                     np.bincount(items, minlength=m))
    args = (users.astype(np.int32), items.astype(np.int32), w, n, m, 4,
            8 if case == "mega_row" else 65536)
    return tell.build_ell_graph(*args), jell.build_ell_graph(*args), n, m, users.size


def _bf16(a):
    return torch.from_numpy(a).bfloat16()


@pytest.mark.parametrize("case", ["powerlaw", "mega_row"])
@pytest.mark.parametrize("masked", [False, True])
def test_bf16_layer_forward_and_vjp_match_jax(jax_ell, case, masked):
    import jax
    import jax.numpy as jnp

    tg, jg, n, m, E = _graphs(case, jax_ell)
    rng = np.random.default_rng(21)
    d = 16
    u, i, gu, gi = (rng.standard_normal((k, d)).astype(np.float32) for k in (n, m, n, m))
    mask = ((rng.random(E) < 0.6) / 0.6).astype(np.float32) if masked else None

    jmask = None if mask is None else jnp.asarray(mask)
    (ju, ji), vjp = jax.vjp(lambda a, b: jax_ell.ell_propagate_layer(jg, a, b, jmask),
                            *(jnp.asarray(a, jnp.bfloat16) for a in (u, i)))
    jdu, jdi = vjp(tuple(jnp.asarray(a, jnp.bfloat16) for a in (gu, gi)))

    tu_in, ti_in = _bf16(u).requires_grad_(), _bf16(i).requires_grad_()
    tu, ti = tell.ell_propagate_layer(tg, tu_in, ti_in,
                                      None if mask is None else torch.from_numpy(mask))
    torch.autograd.backward((tu, ti), (_bf16(gu), _bf16(gi)))

    for got, want in ((tu, ju), (ti, ji), (tu_in.grad, jdu), (ti_in.grad, jdi)):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want.astype(jnp.float32)), rtol=RTOL, atol=ATOL)
