"""The port's host data layer against the JAX package: synthetic
generators, dataset loading, edge normalization, the padded graph and
packed bitsets must give identical arrays from the same inputs."""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="the JAX package is the reference these tests compare with")

import jax.numpy as jnp

from gsrs_tpu import config as jconfig
from gsrs_tpu.data import adjacency as jadj
from gsrs_tpu.data import dataset as jds
from gsrs_tpu.data import synthetic as jsyn
from gsrs_tpu.ops import bitset as jbits
from gsrs_tpu_torch import config as tconfig
from gsrs_tpu_torch.data import adjacency as tadj
from gsrs_tpu_torch.data import dataset as tds
from gsrs_tpu_torch.data import synthetic as tsyn
from gsrs_tpu_torch.ops import bitset as tbits


def _port_data(data):
    return tds.InteractionData(
        name=data.name, n_users=data.n_users, m_items=data.m_items,
        train_users=data.train_users, train_items=data.train_items,
        test_dict=data.test_dict,
    )


def _assert_same_data(a, b):
    assert (a.name, a.n_users, a.m_items) == (b.name, b.n_users, b.m_items)
    np.testing.assert_array_equal(a.train_users, b.train_users)
    np.testing.assert_array_equal(a.train_items, b.train_items)
    assert a.test_dict.keys() == b.test_dict.keys()
    for u in a.test_dict:
        np.testing.assert_array_equal(a.test_dict[u], b.test_dict[u])


@pytest.mark.parametrize("seed,holdout", [(0, 0.0), (7, 0.2)])
def test_powerlaw_matches_jax(seed, holdout):
    _assert_same_data(
        tsyn.powerlaw(120, 90, avg_degree=6, seed=seed, holdout_frac=holdout),
        jsyn.powerlaw(120, 90, avg_degree=6, seed=seed, holdout_frac=holdout),
    )


def test_clustered_matches_jax():
    _assert_same_data(tsyn.clustered(50, 70, n_clusters=3, seed=4),
                      jsyn.clustered(50, 70, n_clusters=3, seed=4))


def test_interaction_views_match_jax():
    t = tsyn.powerlaw(60, 80, avg_degree=5, seed=2, holdout_frac=0.3)
    j = jsyn.powerlaw(60, 80, avg_degree=5, seed=2, holdout_frac=0.3)
    np.testing.assert_array_equal(t.user_degrees, j.user_degrees)
    np.testing.assert_array_equal(t.item_degrees, j.item_degrees)
    assert (t.user_item_net != j.user_item_net).nnz == 0
    for tp, jp in zip(t.all_positives(), j.all_positives()):
        np.testing.assert_array_equal(tp, jp)
    users, items = np.arange(60).repeat(4), np.tile([0, 3, 17, 79], 60)
    np.testing.assert_array_equal(t.feedback_of(users, items), j.feedback_of(users, items))
    np.testing.assert_array_equal(t.test_users(), j.test_users())


def test_load_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    train = [(int(u) * 3 + 5, [int(i) * 7 for i in rng.choice(40, 5, replace=False)])
             for u in range(12)]
    test = [(u, its[:1]) for u, its in train[::2]]
    jds.write_dataset_dir(str(tmp_path), train, test)
    with open(tmp_path / "train.txt", "a") as f:
        f.write("\n3\n")  # blank line and a user without items are skipped
    _assert_same_data(tds.load_dataset(str(tmp_path)), jds.load_dataset(str(tmp_path)))
    t_u, t_i = tds.parse_interaction_file(str(tmp_path / "train.txt"))
    j_u, j_i = jds.parse_interaction_file(str(tmp_path / "train.txt"))
    np.testing.assert_array_equal(t_u, j_u)
    np.testing.assert_array_equal(t_i, j_i)


def test_normalized_edge_weights_match_jax_including_zero_degrees(tiny_data):
    du = tiny_data.user_degrees.copy()
    di = tiny_data.item_degrees.copy()
    du[tiny_data.train_users[0]] = 0  # the zero-degree convention: weight 0
    di[tiny_data.train_items[-1]] = 0
    args = (tiny_data.train_users, tiny_data.train_items, du, di)
    got = tadj.normalized_edge_weights(*args)
    np.testing.assert_array_equal(got, jadj.normalized_edge_weights(*args))
    assert got.dtype == np.float64 and (got == 0).sum() >= 2


def test_build_graph_matches_jax_and_shares_the_cache(tiny_data, tmp_path):
    port = _port_data(tiny_data)
    jg = jadj.build_graph(tiny_data, edge_pad_multiple=256, cache_dir=str(tmp_path))
    tg = tadj.build_graph(port, edge_pad_multiple=256, cache_dir=str(tmp_path))
    for f in dataclasses.fields(tadj.BipartiteGraph):
        np.testing.assert_array_equal(np.asarray(getattr(tg, f.name)),
                                      np.asarray(getattr(jg, f.name)), err_msg=f.name)
    # the port reads the cache the JAX package wrote ...
    with np.load(tmp_path / tadj.CACHE_NAME) as z:
        np.testing.assert_array_equal(tadj._load_cached_weights(
            str(tmp_path / tadj.CACHE_NAME), port), z["weights"])
    # ... and rejects it for a re-shuffled edge list of the same size
    order = np.random.default_rng(0).permutation(port.train_size)
    shuffled = dataclasses.replace(port, train_users=port.train_users[order],
                                   train_items=port.train_items[order])
    assert tadj._load_cached_weights(str(tmp_path / tadj.CACHE_NAME), shuffled) is None


@pytest.mark.parametrize("real_m", [None, 45])
def test_bitset_matches_jax_bit_for_bit(tiny_data, real_m):
    args = (tiny_data.train_users, tiny_data.train_items, tiny_data.n_users,
            tiny_data.m_items, real_m)
    host = tbits.build_bitset(*args)
    np.testing.assert_array_equal(host, jbits.build_bitset(*args))
    dev = tbits.bitset_to_tensor(host, torch.device("cpu"))
    assert dev.dtype == torch.int32
    np.testing.assert_array_equal(tbits.bitset_to_numpy(dev), host)
    rows = np.arange(0, tiny_data.n_users, 3)
    np.testing.assert_array_equal(
        tbits.bitset_row_mask(dev[rows], tiny_data.m_items).numpy(),
        np.asarray(jbits.bitset_row_mask(jnp.asarray(host[rows]), tiny_data.m_items)),
    )
    rng = np.random.default_rng(3)
    users = rng.integers(0, tiny_data.n_users, 200)
    items = rng.integers(0, tiny_data.m_items, 200)
    np.testing.assert_array_equal(
        tbits.bitset_lookup(dev, torch.from_numpy(users), torch.from_numpy(items)).numpy(),
        np.asarray(jbits.bitset_lookup(jnp.asarray(host), jnp.asarray(users),
                                       jnp.asarray(items))),
    )
    if real_m is not None:  # phantom columns are set in every row
        assert tbits.bitset_row_mask(dev, tiny_data.m_items)[:, real_m:].all()


def test_bitset_high_bit_survives_the_int32_view():
    """Bit 31 is the int32 sign bit: the shift sign-extends and & 1 must
    still read every bit exactly."""
    host = tbits.build_bitset(np.zeros(2, np.int64), np.array([31, 63]), 1, 64)
    assert host[0, 0] == np.uint32(1 << 31)
    mask = tbits.bitset_row_mask(tbits.bitset_to_tensor(host, torch.device("cpu")), 64)
    assert mask[0].nonzero().ravel().tolist() == [31, 63]


def test_model_config_matches_jax():
    j = {f.name: f.default for f in dataclasses.fields(jconfig.ModelConfig)}
    t = {f.name: f.default for f in dataclasses.fields(tconfig.ModelConfig)}
    assert t == j
    # a model_meta.json written from the JAX config loads unchanged
    meta = dataclasses.asdict(jconfig.ModelConfig(num_layers=2, use_pop_gate=True))
    assert dataclasses.asdict(tconfig.ModelConfig(**meta)) == meta


@pytest.mark.parametrize("preserve_order", [False, True])
def test_dataset_writers_match_jax(tmp_path, preserve_order):
    rng = np.random.default_rng(7)
    users, items = rng.integers(0, 30, 200), rng.integers(0, 50, 200)
    for pkg, name in ((jds, "jax.txt"), (tds, "port.txt")):
        pkg.write_interaction_file(str(tmp_path / name), users, items, preserve_order)
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    train = [(int(u) * 10 + 3, [int(i) * 7 for i in rng.integers(0, 40, rng.integers(1, 6))])
             for u in rng.permutation(25)]
    test = [(u, [its[0] + 1000]) for u, its in train[:9]]
    sizes = [pkg.write_dataset_dir(str(tmp_path / p), train, test)
             for pkg, p in ((jds, "jdir"), (tds, "tdir"))]
    assert sizes[0] == sizes[1]
    for f in ("train.txt", "test.txt", "user_list.txt", "item_list.txt"):
        assert (tmp_path / "tdir" / f).read_text() == (tmp_path / "jdir" / f).read_text(), f
    _assert_same_data(tds.load_dataset(str(tmp_path / "tdir")),
                      jds.load_dataset(str(tmp_path / "jdir"), name="tdir"))


def test_load_lastfm_matches_jax(tmp_path):
    rng = np.random.default_rng(8)
    rows = [f"{u}\t{i}\t{w}" for u, i, w in zip(rng.integers(1, 40, 300),
                                                 rng.integers(1, 60, 300),
                                                 rng.integers(1, 9, 300))]
    (tmp_path / "data1.txt").write_text("\n".join(rows[:250] + rows[:5]) + "\n")  # duplicates
    (tmp_path / "test1.txt").write_text("\n".join(rows[250:]) + "\n\n")
    _assert_same_data(tds.load_lastfm(str(tmp_path)), jds.load_lastfm(str(tmp_path)))
    empty = tds.load_lastfm(str(tmp_path / "missing"))
    assert (empty.n_users, empty.m_items, empty.train_size) == (0, 0, 0)
