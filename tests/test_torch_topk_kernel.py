"""The exact top-k kernel (``csrc/exact_topk.cu``, `ops/topk.py::exact_topk`).

On the CPU: which inputs `exact_topk` sends to the kernel (a CUDA float32
contiguous matrix with 1 ≤ k ≤ K_MAX and k < m) and that every other input
takes the plain path without loading the library. Marked ``gpu`` (on a
CUDA card only): the kernel's values and ids bitwise `stable_topk`'s
(``lax.top_k``'s order: descending, −0.0 below +0.0, equal scores lowest
column first) and its plain version's (`exact_topk_reference`) on random,
tied, signed-zero, masked and infinite scores, at k = 1, K_MAX and m − 1,
ragged m and unaligned rows, B from 1 to 2,048 (one block a row); no sync
a call; one launch a call. The composite key's order against the
JAX package's ``lax.top_k`` is in tests/test_torch_topk_ties.py and
tests/test_torch_topk_signed_zero.py.
"""

from types import SimpleNamespace

import pytest
import torch

from gsrs_tpu_torch import kernels
from gsrs_tpu_torch.ops import topk
from gsrs_tpu_torch.ops.scoring import NEG_INF


def _bitwise(got, want):
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int64
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))  # −0.0 ≠ +0.0


# ------------------------------------------------------------- on the CPU


def _like(device="cuda", dtype=torch.float32, shape=(4, 100), contiguous=True):
    """What `takes_kernel` reads of a tensor."""
    return SimpleNamespace(is_cuda=device == "cuda", dtype=dtype, shape=shape,
                           is_contiguous=lambda: contiguous)


@pytest.mark.parametrize("scores, k, kernel", [
    (_like(), 20, True),
    (_like(shape=(1, 40981)), 1, True),
    (_like(), topk.K_MAX - 1, False),  # k ≥ m
    (_like(shape=(2, 300)), topk.K_MAX, True),
    (_like(shape=(2, 300)), topk.K_MAX + 1, False),
    (_like(shape=(2, 20)), 20, False),
    (_like(shape=(2, 21)), 20, True),
    (_like(device="cpu"), 20, False),
    (_like(dtype=torch.bfloat16), 20, False),
    (_like(dtype=torch.float64), 20, False),
    (_like(contiguous=False), 20, False),
    (_like(shape=(0, 100)), 20, False),
    (_like(), 0, False),
], ids=["fp32", "B1", "k_ge_m_256", "k_max", "k_over_max", "k_eq_m", "k_m_minus_1", "cpu",
        "bf16", "fp64", "strided", "empty", "k0"])
def test_which_inputs_take_the_kernel(scores, k, kernel):
    assert topk.takes_kernel(scores, k) is kernel


@pytest.mark.parametrize("dtype, m, k", [
    (torch.float32, 100, 20), (torch.float32, 20, 20), (torch.float32, 400, topk.K_MAX + 1),
    (torch.bfloat16, 100, 20),
], ids=["fp32", "k_eq_m", "k_over_max", "bf16"])
def test_cpu_inputs_take_the_plain_path_and_never_load_the_library(monkeypatch, dtype, m, k):
    def refuse(name):
        raise AssertionError(f"loaded {name}")

    monkeypatch.setattr(kernels, "load_library", refuse)
    before = dict(topk.LAUNCHES)
    x = torch.randn(3, m, generator=torch.Generator().manual_seed(m)).to(dtype)
    got = topk.exact_topk(x, k)
    assert topk.LAUNCHES == before  # the plain path's calls are counted on a card only
    want = topk.stable_topk(x, k)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ with no CPU mode")
    return torch.device("cuda:0")


def _scores(kind: str, B: int, m: int, g: torch.Generator, dev) -> torch.Tensor:
    x = torch.randn(B, m, device=dev, generator=g)
    if kind == "rounded":  # a few levels: ties across the k-th boundary
        x = torch.round(x * 2) / 2
    elif kind == "signed_zero":  # ±0.0 and a few ones: the boundary between the zeros
        x = torch.where(torch.rand(B, m, device=dev, generator=g) < 0.5, -0.0, 0.0)
        x[:, ::97] = 1.0
    elif kind == "masked":  # rows all −1e9, rows with fewer than k unmasked, K1's mask
        x[torch.rand(B, m, device=dev, generator=g) < 0.3] = NEG_INF
        x[0] = NEG_INF
        if B > 1:
            x[1] = NEG_INF
            x[1, ::max(1, m // 5)] = 0.5
    elif kind == "ascending":  # each score above every one before it: all pass the threshold
        x = torch.sort(x, dim=1).values
    elif kind == "inf":
        x[:, ::7] = float("inf")
        x[:, 3::11] = float("-inf")
        x[0, :] = float("-inf")
    return x


# (kind, B, m, k)
CASES = [
    ("normal", 2048, 91599, 20),
    ("normal", 1, 40981, 20),
    ("rounded", 3, 40981, 20),
    ("rounded", 133, 9001, 50),
    ("signed_zero", 2, 5003, 20),
    ("signed_zero", 1, 40981, 20),
    ("masked", 3, 4097, 20),
    ("masked", 2, 40981, 20),
    ("inf", 2, 4098, 20),
    ("normal", 3, 4099, 1),
    ("rounded", 2, 4099, 1),
    ("normal", 2, 6000, topk.K_MAX),
    ("rounded", 132, 1003, topk.K_MAX),
    ("normal", 2, 257, topk.K_MAX),
    ("rounded", 3, 33, 32),
    ("normal", 1, 5, 4),
    ("normal", 3, 4 * 1000 + 1, 20),
    ("normal", 3, 4 * 1000 + 2, 20),
    ("normal", 3, 4 * 1000 + 3, 20),
    ("rounded", 200, 40981, 20),
    ("normal", 1, 91599, 256),
    ("ascending", 2, 20001, 20),
    ("ascending", 1, 91599, topk.K_MAX),
    ("ascending", 3, 9001, topk.K_MAX),
    ("normal", 1, 500000, 20),
]


@pytest.mark.gpu
@pytest.mark.parametrize("kind, B, m, k", CASES,
                         ids=[f"{c[0]}-B{c[1]}-m{c[2]}-k{c[3]}" for c in CASES])
def test_kernel_is_stable_topk_bitwise(cuda, kind, B, m, k):
    g = torch.Generator(device=cuda).manual_seed(B * 131 + m + k)
    x = _scores(kind, B, m, g, cuda)
    got = topk.exact_topk(x, k)
    torch.cuda.synchronize()
    _bitwise(got, topk.stable_topk(x, k))
    _bitwise(got, topk.exact_topk_reference(x, k))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_kernel_reads_rows_at_any_offset(cuda, offset):
    """A view that starts 4·offset bytes past a 16-byte boundary, every
    row of it at another offset (m = 4n + 1)."""
    g = torch.Generator(device=cuda).manual_seed(offset)
    B, m, k = 5, 4001, 20
    flat = torch.randn(B * m + offset, device=cuda, generator=g)
    x = flat[offset:].view(B, m)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4 * offset
    _bitwise(topk.exact_topk(x, k), topk.stable_topk(x, k))


@pytest.mark.gpu
@pytest.mark.parametrize("B, m", [(2048, 91599), (1, 40981), (1, 91599)])
def test_a_call_launches_without_a_sync(cuda, B, m):
    x = torch.randn(B, m, device=cuda)
    topk.exact_topk(x, 20)  # builds and loads the library
    torch.cuda.synchronize()
    before = dict(topk.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = topk.exact_topk(x, 20)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    made = {name: n - before[name] for name, n in topk.LAUNCHES.items() if n != before[name]}
    assert made == {"exact_topk": 1}
    _bitwise(got, topk.stable_topk(x, 20))


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["bf16", "k_ge_m", "k_over_max", "strided"])
def test_other_card_inputs_take_the_plain_path(cuda, what):
    x = torch.randn(4, 600, device=cuda)
    k = {"k_ge_m": 600, "k_over_max": topk.K_MAX + 1}.get(what, 20)
    x = {"bf16": x.bfloat16(), "strided": x.T.contiguous().T}.get(what, x)
    before = dict(topk.LAUNCHES)
    got = topk.exact_topk(x, k)
    assert topk.LAUNCHES["exact_topk_plain"] == before["exact_topk_plain"] + 1
    assert topk.LAUNCHES["exact_topk"] == before["exact_topk"]
    want = topk.stable_topk(x, k)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
