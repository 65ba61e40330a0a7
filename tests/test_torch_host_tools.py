"""The port's host utilities against the JAX package's: `utils.timer`
(`Timer`, and `profile_trace` as a torch.profiler context),
`utils.batching`, the MovieLens and Instacart converters (their output
files byte for byte equal to JAX's on tiny inputs), and the native C++
sampler (`gsrs_tpu_torch.native`, a copy of the JAX package's source:
its contract, and the same rows as JAX's for the same seed)."""

import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="the JAX package is the reference these tests compare with")

from gsrs_tpu.data.instacart import prepare_instacart as jinstacart
from gsrs_tpu.data.movielens import prepare_movielens as jmovielens
from gsrs_tpu.native import load_native_sampler as jload_native
from gsrs_tpu.ops.sampling import sample_triplets_host as jhost
from gsrs_tpu.ops.sampling import sample_triplets_python as jpython
from gsrs_tpu.utils import batching as jbatching
from gsrs_tpu.utils.timer import Timer as JTimer
from gsrs_tpu_torch.data.dataset import InteractionData, load_dataset
from gsrs_tpu_torch.data.instacart import prepare_instacart
from gsrs_tpu_torch.data.movielens import main as movielens_main
from gsrs_tpu_torch.data.movielens import prepare_movielens
from gsrs_tpu_torch.native import build as native_build
from gsrs_tpu_torch.native import load_native_sampler
from gsrs_tpu_torch.ops.sampling import sample_triplets_host
from gsrs_tpu_torch.utils import Timer, batching, profile_trace

DATASET_FILES = ("train.txt", "test.txt", "user_list.txt", "item_list.txt")


def port_data(jdata):
    return InteractionData(jdata.name, jdata.n_users, jdata.m_items, jdata.train_users,
                           jdata.train_items, jdata.test_dict)


def assert_same_dirs(a, b):
    for name in DATASET_FILES:
        with open(os.path.join(a, name)) as f, open(os.path.join(b, name)) as g:
            assert f.read() == g.read(), name


# ------------------------------------------------------------------ utils


def test_timer_matches_jax():
    for T in (Timer, JTimer):
        T.zero()
        for _ in range(3):
            with T.named("sample"):
                pass
        with T("step") as t:
            pass
        assert t.elapsed >= 0.0
        with T():  # unnamed: timed, not taped
            pass
    assert Timer.counts() == JTimer.counts() == {"sample": 3, "step": 1}
    assert set(Timer.dict()) == set(JTimer.dict())
    assert Timer.summary().count("|") == JTimer.summary().count("|") == 1
    Timer.zero()
    assert Timer.dict() == {} and Timer.counts() == {}


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(None):
        torch.ones(3).sum()
    assert os.listdir(tmp_path) == []
    with profile_trace(str(tmp_path / "prof")):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")


def test_minibatch_and_shuffle_match_jax():
    a, b = np.arange(10), np.arange(10) * 2
    got = list(batching.minibatch(a, b, batch_size=4))
    want = list(jbatching.minibatch(a, b, batch_size=4))
    assert len(got) == len(want) == 3 and len(got[-1][0]) == 2  # the ragged tail kept
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(list(batching.minibatch(a, batch_size=3))[-1], [9])
    sa, sb = batching.shuffle(a, b, rng=np.random.default_rng(0))
    ja, jb = jbatching.shuffle(a, b, rng=np.random.default_rng(0))
    np.testing.assert_array_equal(sa, ja)
    np.testing.assert_array_equal(sb, sa * 2)
    assert not np.array_equal(sa, a)
    np.testing.assert_array_equal(batching.shuffle(a, rng=np.random.default_rng(1)),
                                  jbatching.shuffle(a, rng=np.random.default_rng(1)))
    with pytest.raises(ValueError, match="same length"):
        batching.shuffle(a, b[:3])


# ------------------------------------------------------------- converters


def test_instacart_matches_jax(tmp_path):
    import pandas as pd

    # 3 users; u1 has 3 prior orders, u2 has 2, u3 has 1 (filtered out)
    orders = pd.DataFrame({"order_id": [1, 2, 3, 4, 5, 6, 7],
                           "user_id": [1, 1, 1, 2, 2, 3, 1],
                           "eval_set": ["prior"] * 6 + ["train"],
                           "order_number": [1, 2, 3, 1, 2, 1, 4]})
    products = pd.DataFrame({"order_id": [1, 1, 2, 3, 3, 4, 5, 6],
                             "product_id": [10, 11, 10, 12, 13, 20, 21, 30]})
    raw = tmp_path / "raw"
    raw.mkdir()
    orders.to_csv(raw / "orders.csv", index=False)
    products.to_csv(raw / "order_products__prior.csv", index=False)
    args = (str(raw / "orders.csv"), str(raw / "order_products__prior.csv"))
    got = prepare_instacart(*args, str(tmp_path / "port"), min_orders=2)
    want = jinstacart(*args, str(tmp_path / "jax"), min_orders=2)
    assert got == want == (2, 6)
    assert_same_dirs(tmp_path / "port", tmp_path / "jax")
    data = load_dataset(str(tmp_path / "port"))
    assert data.train_size == 3 and len(data.test_dict) == 2
    # the seeded user subsample
    got = prepare_instacart(*args, str(tmp_path / "port_s"), min_orders=1, sample_frac=0.5,
                            seed=3)
    want = jinstacart(*args, str(tmp_path / "jax_s"), min_orders=1, sample_frac=0.5, seed=3)
    assert got == want
    assert_same_dirs(tmp_path / "port_s", tmp_path / "jax_s")


RATINGS = [(1, 10, 5, 100), (1, 11, 4, 200), (1, 12, 5, 300), (1, 13, 4, 400),
           (2, 10, 4, 100), (2, 11, 3, 200), (2, 12, 4, 300)]


@pytest.mark.parametrize("fmt", ["u.data", "ratings.dat", "ratings.csv"])
@pytest.mark.parametrize("split", ["leave_last", "ratio"])
def test_movielens_matches_jax(tmp_path, fmt, split):
    path = tmp_path / fmt
    if fmt == "u.data":
        path.write_text("".join(f"{u}\t{i}\t{r}\t{t}\n" for u, i, r, t in RATINGS))
    elif fmt == "ratings.dat":
        path.write_text("".join(f"{u}::{i}::{r}::{t}\n" for u, i, r, t in RATINGS))
    else:
        path.write_text("userId,movieId,rating,timestamp\n"
                        + "".join(f"{u},{i},{r}.0,{t}\n" for u, i, r, t in RATINGS))
    kw = dict(min_rating=4.0, min_interactions=2, split=split, test_frac=0.5)
    got = prepare_movielens(str(path), str(tmp_path / "port"), **kw)
    want = jmovielens(str(path), str(tmp_path / "jax"), **kw)
    assert got == want == (2, 4)
    assert_same_dirs(tmp_path / "port", tmp_path / "jax")


def test_movielens_cli_and_errors(tmp_path, capsys):
    path = tmp_path / "u.data"
    path.write_text("".join(f"{u}\t{i}\t{r}\t{t}\n" for u, i, r, t in RATINGS))
    movielens_main(["--ratings", str(path), "--out_dir", str(tmp_path / "ml"), "--split",
                    "leave_last", "--min_interactions", "2"])
    assert "2 users, 4 items" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unknown split"):
        prepare_movielens(str(path), str(tmp_path / "x"), split="random")
    with pytest.raises(ValueError, match="no ratings"):
        prepare_movielens(str(path), str(tmp_path / "x"), min_rating=6.0)


# ---------------------------------------------------------- native sampler


@pytest.fixture(scope="module")
def native():
    lib = load_native_sampler()
    if lib is None:
        pytest.skip("no host C++ compiler: the native sampler cannot be built")
    return lib


def _dense_mask(data):
    m = np.zeros((data.n_users, data.m_items), bool)
    m[data.train_users, data.train_items] = True
    return m


def _args(data):
    net = data.user_item_net
    return data.n_users, data.m_items, data.train_size, net.indptr, net.indices


def test_native_builds_from_the_package_into_build(native):
    path = native_build.library_path()
    assert os.path.exists(path)
    assert os.sep + os.path.join("build", "native") + os.sep in path
    with open(native_build.SOURCE) as f, open(os.path.join(
            os.path.dirname(jload_native.__code__.co_filename), "sampling.cpp")) as g:
        code = f.read()
        ref = g.read()
    # the same code after the header comment
    assert code[code.index("#include"):] == ref[ref.index("#include"):]


def test_native_sample_negative_contract(native, tiny_data):
    native.seed(2020)
    S = native.sample_negative(*_args(tiny_data), neg_num=1)
    assert S.shape[1] == 3
    assert len(S) <= (tiny_data.train_size // tiny_data.n_users) * tiny_data.n_users
    mask = _dense_mask(tiny_data)
    assert mask[S[:, 0], S[:, 1]].all()
    assert not mask[S[:, 0], S[:, 2]].any()


def test_native_multi_negative(native, tiny_data):
    native.seed(7)
    S = native.sample_negative(*_args(tiny_data), neg_num=4)
    assert S.shape[1] == 6
    mask = _dense_mask(tiny_data)
    assert mask[S[:, 0], S[:, 1]].all()
    for j in range(2, 6):
        assert not mask[S[:, 0], S[:, j]].any()


def test_native_by_user(native, tiny_data):
    net = tiny_data.user_item_net
    users = np.arange(0, tiny_data.n_users, 2, dtype=np.int64)
    S = native.sample_negative_by_user(users, tiny_data.m_items, net.indptr, net.indices)
    valid = users[tiny_data.user_degrees[users] > 0]
    np.testing.assert_array_equal(S[:, 0], valid)
    mask = _dense_mask(tiny_data)
    assert mask[S[:, 0], S[:, 1]].all()
    assert not mask[S[:, 0], S[:, 2]].any()
    with pytest.raises(ValueError, match="out of range"):
        native.sample_negative_by_user(np.array([tiny_data.n_users]), tiny_data.m_items,
                                       net.indptr, net.indices)


def test_native_seed_determinism(native, tiny_data):
    native.seed(7)
    a = native.sample_negative(*_args(tiny_data))
    native.seed(7)
    b = native.sample_negative(*_args(tiny_data))
    np.testing.assert_array_equal(a, b)
    native.seed(8)
    assert not np.array_equal(a, native.sample_negative(*_args(tiny_data)))


@pytest.mark.parametrize("neg_num", [1, 3])
def test_native_rows_equal_jax_native(native, tiny_data, neg_num):
    """Both packages compile the same C++ source: the same seed gives the
    same rows, round robin and by user."""
    jnative = jload_native()
    if jnative is None:
        pytest.skip("the JAX package's native sampler did not build")
    net = tiny_data.user_item_net
    users = np.arange(tiny_data.n_users, dtype=np.int64)[::-1].copy()
    for lib in (native, jnative):
        lib.seed(11)
    np.testing.assert_array_equal(native.sample_negative(*_args(tiny_data), neg_num=neg_num),
                                  jnative.sample_negative(*_args(tiny_data), neg_num=neg_num))
    np.testing.assert_array_equal(
        native.sample_negative_by_user(users, tiny_data.m_items, net.indptr, net.indices,
                                       neg_num),
        jnative.sample_negative_by_user(users, tiny_data.m_items, net.indptr, net.indices,
                                        neg_num))


def test_host_dispatch_matches_jax(tiny_data):
    got = sample_triplets_host(port_data(tiny_data), 200, seed=1)
    assert got.shape[1] == 3
    mask = _dense_mask(tiny_data)
    assert mask[got[:, 0], got[:, 1]].all()
    assert not mask[got[:, 0], got[:, 2]].any()
    if load_native_sampler() is not None and jload_native() is not None:
        np.testing.assert_array_equal(got, jhost(tiny_data, 200, seed=1))


def test_python_fallback_matches_jax(tiny_data, monkeypatch):
    """Without the native sampler the dispatch takes the Python sampler,
    whose rows equal JAX's for the same seed."""
    from gsrs_tpu_torch import native as native_pkg

    monkeypatch.setattr(native_pkg, "load_native_sampler", lambda: None)
    got = sample_triplets_host(port_data(tiny_data), 150, seed=4)
    np.testing.assert_array_equal(got, jpython(np.random.default_rng(4), tiny_data, 150))
