"""The table row gather and its hand-written backward
(`gsrs_tpu_torch/ops/gather.py`, ``csrc/gather_rows_grad.cu``).

On the CPU: `gather_rows` and `gather_rows_cat` are ``table[ids]``
(forward and backward bit for bit, the library never loaded, nothing
counted), `gather_rows_grad_plain` is autograd's backward of
``table[ids]`` bit for bit, and the wrappers refuse what the kernel does
not take. Marked ``gpu`` (on a CUDA card only): the kernel against a
float64 ``index_add_`` at the two training cells' shapes (BERT4Rec's
batch of 51,200 ids, 27,700 of them PAD and 4,300 MASK, into 26,746
rows; Gowalla's 393,216 Zipf ids into 40,981 rows), one id 100,000 times,
no ids, every row, bf16, a strided and an expanded gradient, widths 1 to
256: exact on integer-valued gradients (every partial sum representable),
within fp32's recursive-summation bound on normal ones; two calls bitwise
equal; out-of-range and negative ids fail the device-side assert (in a
process of their own, since an assert ends the CUDA context); one launch
a call and no host sync; two BERT4Rec trainings of 3 steps from one seed
bitwise equal.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gsrs_tpu_torch import kernels
from gsrs_tpu_torch.ops import gather

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------- on the CPU


@pytest.fixture
def no_library(monkeypatch):
    def refuse(name):
        raise AssertionError(f"loaded {name}")

    monkeypatch.setattr(kernels, "load_library", refuse)
    before = dict(gather.LAUNCHES)
    yield
    assert gather.LAUNCHES == before


def _cpu_case(dtype, id_dtype, shape, rows=37, d=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    table = torch.randn(rows, d, generator=g).to(dtype)
    ids = torch.randint(0, rows, shape, generator=g).to(id_dtype)
    ids.view(-1)[: ids.numel() // 3] = 4  # a run
    up = torch.randn(*shape, d, generator=g).to(dtype)
    return table, ids, up


def _grad_of(fn, table, up):
    t = table.clone().requires_grad_(True)
    out = fn(t)
    out.backward(up)
    return out.detach(), t.grad


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("shape", [(40,), (6, 9), (0,)], ids=["flat", "seqs", "empty"])
def test_cpu_gather_rows_is_table_indexing_bitwise(no_library, dtype, id_dtype, shape):
    table, ids, up = _cpu_case(dtype, id_dtype, shape)
    got = _grad_of(lambda t: gather.gather_rows(t, ids), table, up)
    want = _grad_of(lambda t: t[ids], table, up)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == dtype and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_cpu_gather_rows_cat_is_separate_gathers_bitwise(no_library, dtype):
    table, a, up_a = _cpu_case(dtype, torch.int64, (30, 4), seed=1)
    _, b, up_b = _cpu_case(dtype, torch.int64, (12, 4), seed=2)

    def cat_grad(fn):
        t = table.clone().requires_grad_(True)
        outs = fn(t)
        torch.autograd.backward(outs, (up_a, up_b))
        return [o.detach() for o in outs], t.grad

    (got_a, got_b), got_g = cat_grad(lambda t: gather.gather_rows_cat(t, a, b))
    (want_a, want_b), want_g = cat_grad(lambda t: (t[a], t[b]))
    assert torch.equal(got_a, want_a) and torch.equal(got_b, want_b)
    assert torch.equal(got_g, want_g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(40,), (6, 9), (0,)], ids=["flat", "seqs", "empty"])
def test_cpu_plain_backward_is_autograds_bitwise(no_library, dtype, shape):
    table, ids, up = _cpu_case(dtype, torch.int64, shape, seed=3)
    _, want = _grad_of(lambda t: t[ids], table, up)
    got = gather.gather_rows_grad_plain(up, ids, table.shape[0])
    assert got.dtype == dtype and torch.equal(got, want)


def test_cpu_tables_without_a_gradient_are_plain_indexing(no_library):
    table, ids, _ = _cpu_case(torch.float32, torch.int64, (9,))
    with torch.no_grad():
        assert torch.equal(gather.gather_rows(table.requires_grad_(True), ids), table[ids])


@pytest.mark.parametrize("what", ["fp64", "fp16", "1d", "int16_ids", "float_ids"])
def test_tables_and_ids_the_kernel_does_not_take_are_refused(what):
    table = torch.zeros(8, 4)
    ids = torch.arange(3)
    if what == "fp64":
        table = table.double()
    elif what == "fp16":
        table = table.half()
    elif what == "1d":
        table = torch.zeros(8)
    elif what == "int16_ids":
        ids = ids.to(torch.int16)
    else:
        ids = ids.float()
    with pytest.raises(ValueError, match="gather_rows takes"):
        gather._check_table(table, ids)


@pytest.mark.parametrize("what", ["cpu", "fp64", "int16_ids", "shape", "rows"])
def test_the_kernels_wrapper_refuses_before_any_launch(no_library, what):
    grad, ids, rows = torch.zeros(3, 4), torch.arange(3), 8
    if what == "fp64":
        grad = grad.double()
    elif what == "int16_ids":
        ids = ids.to(torch.int16)
    elif what == "shape":
        grad = torch.zeros(4, 4)
    elif what == "rows":
        rows = 0
    if what != "cpu":  # a card's tensors, as the wrapper reads them
        grad = _on_a_card(grad)
        ids = _on_a_card(ids)
    with pytest.raises(ValueError, match="gather_rows_grad"):
        gather.gather_rows_grad(grad, ids, rows)


class _CardTensor(torch.Tensor):
    """A CPU tensor that reads as a card's: what the wrapper checks before
    it launches."""

    @property
    def is_cuda(self):
        return True


def _on_a_card(t):
    return t.as_subclass(_CardTensor)


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ with no CPU mode")
    return torch.device("cuda:0")


def _zipf(n, rows, s, rng, first=0):
    p = np.arange(1, rows - first + 1, dtype=np.float64) ** -s
    return first + rng.choice(rows - first, size=n, p=p / p.sum())


def _ids(case, rng):
    """(ids, rows, d) of a case (numpy ids)."""
    if case == "bert4rec":  # PAD 0, items 1..26,744, MASK 26,745
        rows = 26746
        ids = np.concatenate([np.zeros(27700, np.int64), np.full(4300, rows - 1),
                              _zipf(51200 - 32000, rows - 1, 1.1, rng, first=1)])
        return rng.permutation(ids).reshape(256, 200), rows, 64
    if case == "gowalla":
        return _zipf(393216, 40981, 1.1, rng), 40981, 64
    if case == "one_id_100k":
        return np.full(100000, 7), 50, 64
    if case == "no_ids":
        return np.zeros(0, np.int64), 1000, 64
    if case == "every_row":
        return rng.permutation(np.concatenate([np.arange(5000), rng.integers(0, 5000, 3000)])), \
            5000, 64
    if case.startswith("d"):  # widths: one lane's column, ragged tiles, two tiles of 128
        d = int(case[1:])
        return _zipf(20000, 3000, 1.1, rng), 3000, d
    raise ValueError(case)


def _reference(up, ids, rows):
    """float64 ``index_add_``, and Σ|g| per element (the bound's scale)."""
    d = up.shape[-1]
    g = up.reshape(-1, d).double()
    flat = ids.reshape(-1).long()
    ref = torch.zeros(rows, d, dtype=torch.float64, device=up.device).index_add_(0, flat, g)
    mag = torch.zeros_like(ref).index_add_(0, flat, g.abs())
    count = torch.bincount(flat, minlength=rows).double()[:, None]
    return ref, mag, count


CASES = ["bert4rec", "gowalla", "one_id_100k", "no_ids", "every_row", "d1", "d33", "d50",
         "d256"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("id_dtype", [torch.int64, torch.int32], ids=["int64", "int32"])
def test_kernel_against_a_float64_index_add(cuda, case, dtype, id_dtype):
    rng = np.random.default_rng(CASES.index(case) + 100 * (dtype == torch.bfloat16))
    ids_np, rows, d = _ids(case, rng)
    ids = torch.from_numpy(np.asarray(ids_np)).to(cuda, id_dtype)
    # integers of [-8, 8]: every partial sum exact in fp32, so any order gives the reference
    whole = torch.from_numpy(rng.integers(-8, 9, (*ids.shape, d))).to(cuda, dtype)
    ref, _, _ = _reference(whole, ids, rows)
    got = gather.gather_rows_grad(whole, ids, rows)
    torch.cuda.synchronize()
    assert got.shape == (rows, d) and got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, ref.to(dtype))
    # normal values: within fp32's bound for a sum of `count` terms, then the dtype's rounding
    normal = torch.randn(*ids.shape, d, device=cuda).to(dtype)
    ref, mag, count = _reference(normal, ids, rows)
    got = gather.gather_rows_grad(normal, ids, rows).double()
    bound = (count + 1) * 2.0**-24 * mag
    if dtype == torch.bfloat16:  # then rounded once, by half a unit in its last place at most
        bound = bound + 2.0**-8 * (ref.abs() + bound)
    assert bool(((got - ref).abs() <= bound).all())
    if case == "bert4rec":  # the PAD row's run of zeros sums to zero exactly
        zeros = torch.where(ids == 0, 0.0, 1.0)[..., None].to(dtype) * normal
        assert bool((gather.gather_rows_grad(zeros, ids, rows)[0] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["strided", "expanded", "transposed"])
def test_kernel_reads_any_gradient_layout(cuda, layout):
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(_zipf(6000, 900, 1.1, rng)).to(cuda).reshape(60, 100)
    base = torch.from_numpy(rng.integers(-8, 9, (60, 100, 2 * 64))).to(cuda, torch.float32)
    up = {"strided": base[..., ::2],  # column stride 2
          "expanded": base[:1, :1, :64].expand(60, 100, 64),  # row stride 0
          "transposed": base[..., :64].transpose(0, 1).contiguous().transpose(0, 1)}[layout]
    assert not up.is_contiguous()
    got = gather.gather_rows_grad(up, ids, 900)
    assert torch.equal(got, _reference(up, ids, 900)[0].float())
    assert torch.equal(got, gather.gather_rows_grad(up.contiguous(), ids, 900))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["bert4rec", "gowalla", "one_id_100k"])
def test_two_calls_are_bitwise_equal(cuda, case):
    ids_np, rows, d = _ids(case, np.random.default_rng(6))
    ids = torch.from_numpy(np.asarray(ids_np)).to(cuda)
    up = torch.randn(*ids.shape, d, device=cuda)
    first = gather.gather_rows_grad(up, ids, rows)
    second = gather.gather_rows_grad(up, ids, rows)
    assert torch.equal(_bits(first), _bits(second))


_RAISES = """
import torch
from gsrs_tpu_torch.ops import gather
ids = torch.tensor([0, {bad}, 1], dtype=torch.{dtype}, device="cuda")
out = gather.gather_rows_grad(torch.ones(3, 8, device="cuda"), ids, 5)
torch.cuda.synchronize()
print("NO ERROR", out.sum().item())
"""


@pytest.mark.gpu
@pytest.mark.parametrize("bad, dtype", [(-1, "int64"), (5, "int64"), (2**40, "int64"),
                                        (-3, "int32"), (7, "int32")],
                         ids=["negative", "rows", "past_int32", "negative_int32", "rows_int32"])
def test_out_of_range_and_negative_ids_raise(cuda, bad, dtype):
    proc = subprocess.run([sys.executable, "-c", _RAISES.format(bad=bad, dtype=dtype)],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "NO ERROR" not in proc.stdout, proc.stdout + proc.stderr
    assert "assert" in proc.stderr.lower(), proc.stderr[-2000:]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_one_launch_a_backward_and_no_sync(cuda, dtype):
    ids_np, rows, d = _ids("bert4rec", np.random.default_rng(8))
    ids = torch.from_numpy(ids_np).to(cuda)
    table = torch.randn(rows, d, device=cuda).to(dtype).requires_grad_(True)
    gather.gather_rows(table, ids).sum().backward()  # builds and loads the library
    torch.cuda.synchronize()
    table.grad = None
    before = dict(gather.LAUNCHES)
    out = gather.gather_rows(table, ids)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out.float().square().sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    made = {k: n - before[k] for k, n in gather.LAUNCHES.items() if n != before[k]}
    assert made == {"gather_rows_grad": 1}
    # the gradient reaching the gather is 2·out, exactly, in the table's dtype
    want = gather.gather_rows_grad((2 * out.detach().float()).to(dtype), ids, rows)
    assert torch.equal(_bits(table.grad), _bits(want))


@pytest.mark.gpu
def test_refused_on_the_card(cuda):
    table = torch.zeros(8, 4, device=cuda, dtype=torch.float64, requires_grad=True)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        gather.gather_rows(table, torch.arange(3, device=cuda))
    with pytest.raises(ValueError, match="device"):
        gather.gather_rows(table.detach().float().requires_grad_(True), torch.arange(3))


@pytest.mark.gpu
def test_bert4rec_trainings_from_one_seed_are_bitwise_equal(cuda):
    from gsrs_tpu_torch.data.sequences import SequenceData
    from gsrs_tpu_torch.models.registry import build_seq_model
    from gsrs_tpu_torch.train.seq_trainer import SeqTrainer

    m, n_len, rows = 500, 50, 256
    rng = np.random.default_rng(9)
    lengths = rng.integers(2, n_len + 1, rows)
    seqs = np.zeros((rows, n_len), np.int64)
    for u, k in enumerate(lengths):
        seqs[u, n_len - k:] = _zipf(k, m + 1, 1.1, rng, first=1)
    hist = {u: row[row > 0] for u, row in enumerate(seqs)}
    data = SequenceData("tiny", rows, m, n_len, seqs, seqs, np.arange(rows),
                        rng.integers(1, m + 1, rows), hist)
    runs = []
    for _ in range(2):
        model = build_seq_model("bert4rec", m, max_len=n_len, dim=64, hidden=256, blocks=2,
                                heads=2, dropout=0.1, mask_prob=0.2, published=10, device=cuda,
                                generator=torch.Generator().manual_seed(3))
        tr = SeqTrainer(model, data, batch_size=64, lr=1e-3, seed=4, topks=(10,),
                        eval_batch=64, warmup_steps=0, decay_steps=100, weight_decay=0.01,
                        clip_norm=5.0, device=cuda)
        tr.steps_per_call = 3
        before = gather.LAUNCHES["gather_rows_grad"]
        state, _ = tr.train_epoch(tr.init_state())
        assert gather.LAUNCHES["gather_rows_grad"] - before == 3  # the encoder's item table
        runs.append({k: p.detach().clone() for k, p in state.params.items()})
    for k, p in runs[0].items():
        assert torch.equal(_bits(p), _bits(runs[1][k])), k
