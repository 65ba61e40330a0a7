"""The yardstick's arithmetic on hand-worked shapes."""

import pytest

from benchmark.counts import kernels, lightgcn, peaks


def test_k1_at_the_amazon_book_eval_batch():
    # 2 * 2048 * 91,599 * 64 = 24.01 GFLOP at 67 TFLOP/s
    assert kernels.k1_least_s(2048, 91599, 64, 2863, 20) == pytest.approx(358.4e-6, rel=1e-3)


def test_k4_counts_slots_sources_and_outputs():
    # 1,000 nonzero slots of 8 B, 500 source and 200 output rows of 64 fp32
    nbytes = 8 * 1000 + 4 * (500 + 200) * 64
    assert kernels.k4_least_s(1000, 500, 200, 64, 4) == pytest.approx(nbytes / 3.35e12)


def test_k3_reads_four_and_writes_three_arrays():
    leaves = [(29858 * 64, 4), (40981 * 64, 4)]
    n = sum(c for c, _ in leaves)
    assert kernels.k3_least_s(leaves) == pytest.approx(7 * 4 * n / 3.35e12)


def test_least_time_names_its_bound():
    assert peaks.least_s(67e12, 0.0)[1] == "flops"
    assert peaks.least_s(0.0, 3.35e12) == (1.0, "bytes")


def test_train_step_and_eval_counts():
    cfg = {"data": {"n_users": 10, "m_items": 20, "n_train": 100},
           "model": {"embedding_dim": 4, "num_layers": 1, "bf16_compute": False},
           "train": {"batch_size": 8}}
    flops, nbytes = lightgcn.prop_work(cfg, 4)
    assert flops == 4 * 100 * 4 and nbytes == 2 * 8 * 100 + 2 * 4 * 30 * 4
    step_s, bound = lightgcn.train_step_least(cfg)
    want = 2 * nbytes + 2 * 3 * 8 * 4 * 4 + 7 * 4 * 30 * 4
    assert (step_s, bound) == (pytest.approx(want / 3.35e12), "bytes")
    ev_s, _ = lightgcn.eval_least(cfg, 5, 1, 20)
    ev_bytes = nbytes + 4 * (5 * 4 + 20 * 4 + 5 * 1) + 8 * 5 * 20
    assert ev_s == pytest.approx(max(ev_bytes / 3.35e12, (flops + 2 * 5 * 20 * 4) / 67e12))
