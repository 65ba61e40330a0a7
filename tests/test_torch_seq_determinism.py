"""The CPU side of `chip_smoke.py`'s sequential card-vs-CPU check is
repeatable: `seq_steps` on the CPU runs under
`torch.use_deterministic_algorithms(True)` (`deterministic_on_cpu`), so
two runs of the 3 steps of each model give bitwise-equal losses, first
gradients and parameters, at 1 thread and at several (without the
setting, two runs at 8 threads differ: SASRec's parameters by up to
3.4e-6 on this data), and the previous setting is restored afterwards.
Across thread counts the CPU's GEMMs block differently, so the check is
within a thread count."""

import importlib.util
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)  # defines main() but does not run it
    return module


def _steps(smoke, kind, threads):
    from gsrs_tpu_torch.data import synthetic
    from gsrs_tpu_torch.data.sequences import sequences_from_interactions

    cpu = torch.device("cpu")
    inter = synthetic.powerlaw(1600, 300, avg_degree=12, seed=smoke.SEED + 1, holdout_frac=0.2)
    data = sequences_from_interactions(inter, max_len=smoke.SEQ_SMALL_LEN)
    host = smoke.seq_trainer(kind, False, data, smoke.SEED + 1, cpu)
    batches = host.epoch_batches(0)[:3]
    g = torch.Generator().manual_seed(smoke.SEED + 101)
    draws = [host.draw_step(b, g) for b in batches]
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        losses, params, grads, _ = smoke.seq_steps(kind, False, data, batches, draws,
                                                   smoke.SEED + 1, cpu)
    finally:
        torch.set_num_threads(before)
    return losses, params, grads


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("kind", ["sasrec", "gru4rec", "bert4rec"])
def test_cpu_side_is_bitwise_repeatable(smoke, kind, threads):
    assert not torch.are_deterministic_algorithms_enabled()
    first = _steps(smoke, kind, threads)
    second = _steps(smoke, kind, threads)
    assert not torch.are_deterministic_algorithms_enabled()  # restored
    assert torch.equal(first[0], second[0])
    for got, want in zip(second[1:], first[1:]):
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_the_previous_setting_is_restored(smoke):
    cpu, card = torch.device("cpu"), torch.device("cuda:0")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with smoke.deterministic_on_cpu(cpu):
            assert torch.are_deterministic_algorithms_enabled()
            assert not torch.is_deterministic_algorithms_warn_only_enabled()
        assert torch.is_deterministic_algorithms_warn_only_enabled()
    finally:
        torch.use_deterministic_algorithms(False)
    with smoke.deterministic_on_cpu(card):  # the card's side runs as it is
        assert not torch.are_deterministic_algorithms_enabled()
    assert not torch.are_deterministic_algorithms_enabled()
