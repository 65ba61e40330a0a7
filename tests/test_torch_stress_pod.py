"""The port's pod-scale stress harness (`gsrs_tpu_torch.stress_pod`)
against the JAX package's `tools/stress_pod.py`: the same memory plan for
the same inputs on a TPU chip name, the H100's plan worked by hand, the
same synthetic generator output for the same seed, and the tiny run on a
2 × 2 mesh of gloo ranks on the CPU."""

import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from gsrs_tpu_torch import stress_pod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GiB = 2**30


@pytest.fixture(scope="module")
def jax_stress():
    spec = importlib.util.spec_from_file_location(
        "jax_stress_pod", os.path.join(ROOT, "tools", "stress_pod.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("point", [
    (50_000_000, 10_000_000, 256, 27, 65536, 1024, 4, 16, "v5e"),
    (50_000_000, 10_000_000, 256, 27, 65536, 1024, 2, 32, "v5e"),
    (1_000_000, 500_000, 256, 27, 65536, 1024, 1, 1, "v5p"),
    (2000, 1500, 32, 10, 512, 128, 2, 2, "v4"),
])
def test_plan_equals_the_jax_harness(jax_stress, point):
    *shape, data_axis, model_axis, chip = point
    want = jax_stress.memory_plan(*shape, data_axis=data_axis, model_axis=model_axis, chip=chip)
    assert stress_pod.memory_plan(*shape, data_axis=data_axis, model_axis=model_axis,
                                  chip=chip) == want
    argv = ["--n_users", str(shape[0]), "--m_items", str(shape[1]), "--dim", str(shape[2]),
            "--avg_degree", str(shape[3]), "--batch", str(shape[4]), "--eval_batch",
            str(shape[5]), "--data_axis", str(data_axis), "--model_axis", str(model_axis),
            "--chip", chip, "--plan_only"]
    assert stress_pod.main(argv) == want


def test_h100_plan_by_hand():
    """1M users × 500k items, dim 256, degree 27 on one H100 (80 GiB, 80%
    usable): fp32 tables and Adam moments 1.5M · 256 · 12 B, bf16
    activations 3 · 1.5M · 256 · 2 B, ELL slots 27M · 2 · 12 · 1.25 B, the
    (1024, 500k) fp32 score block; the 62.5 GB sampler bitset is past the
    8 GiB cutoff, so it is left out."""
    plan = stress_pod.memory_plan(1_000_000, 500_000, 256, 27, 65536, 1024, 1, 1)
    assert plan["chip"] == "h100" and stress_pod.HBM_PER_CHIP["h100"] == 80
    parts = {"tables+adam": 1.5e6 * 256 * 12, "propagation_activations": 3 * 1.5e6 * 256 * 2,
             "ell_edges": 27e6 * 2 * 12 * 1.25, "eval_scores": 1024 * 500_000 * 4}
    for k, v in parts.items():
        assert plan["per_device_GiB"][k] == round(v / GiB, 3)
    assert plan["per_device_GiB"]["sampler_bitset"] == 0 and not plan["bitset_sampler"]
    assert plan["per_device_GiB"]["total"] == round(sum(parts.values()) / GiB, 3) == 9.099
    assert plan["fits"] and plan["min_model_axis_for_fit"] == 1
    # BASELINE config 5 on a 4 x 16 mesh of H100s: its tables, moments and
    # activations (276.5 GB whole) need ceil(276.5 GB / 64 GiB) = 5 model shards
    pod = stress_pod.memory_plan(50_000_000, 10_000_000, 256, 27, 65536, 1024, 4, 16)
    need = (60e6 * 256 * 12 + 3 * 60e6 * 256 * 2) / (80 * GiB * 0.8)
    assert pod["fits"] and pod["min_model_axis_for_fit"] == math.ceil(need) == 5


def test_big_synthetic_equals_the_jax_harness(jax_stress):
    got = stress_pod.big_synthetic(500, 200, avg_degree=5, seed=0)
    want = jax_stress.big_synthetic(500, 200, avg_degree=5, seed=0)
    assert (got.name, got.n_users, got.m_items) == (want.name, want.n_users, want.m_items)
    np.testing.assert_array_equal(got.train_users, want.train_users)
    np.testing.assert_array_equal(got.train_items, want.train_items)
    assert got.train_users.dtype == np.int64 and got.test_dict == {}


def test_smoke_runs_on_four_gloo_ranks():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-m", "gsrs_tpu_torch.stress_pod", "--smoke",
                          "--device", "cpu", "--steps", "4"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "STRESS OK"
    train, evaluation, memory = (json.loads(line) for line in lines[-4:-1])
    assert math.isfinite(train["loss"]) and train["train_step_ms"] > 0
    assert evaluation["eval_topk_ms"] > 0
    assert memory["device"] == "cpu" and memory["peak_device_GiB"] is None
    assert '"mesh": "data=2 x model=2"' in out.stdout
