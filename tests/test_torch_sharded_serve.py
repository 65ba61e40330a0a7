"""Sharded serving (`gsrs_tpu_torch.serve.Retriever` with a mesh) on gloo
ranks spawned on the CPU, against the JAX package's single-device
Retriever: the same items for every user and the same scores within 1e-5
(fp32 products summed in another order), at mesh shapes (2, 2) and
(1, 4), with every rank answering and no phantom (padding) item ever
served; the int8 artifact on a mesh gives the one-card int8 answer
exactly (shard by shard, the same arithmetic). ``serve export
--model_axis 2`` of an odd-sized dataset writes the canonical artifact
(the real rows, equal to the one-card export), and ``serve query
--model_axis 2`` starts its two ranks and prints the one-card answer.
The children import no JAX."""


import numpy as np
import pytest

from gsrs_tpu_torch import cli
from gsrs_tpu_torch import serve as tserve
from gsrs_tpu_torch.data.dataset import write_interaction_file
from gsrs_tpu_torch.data.synthetic import clustered
from gsrs_tpu_torch.parallel.launch import spawn
from gsrs_tpu_torch.parallel.mesh import make_mesh

SCORE_ATOL = 1e-5
SHAPES = [(2, 2), (1, 4)]


def _serve_rank(device, art, q_art, users):
    out = {}
    for d, m in SHAPES:
        mesh = make_mesh(data_axis=d, model_axis=m, device=device)
        request = users if mesh.is_primary else None  # rank 0 takes the request
        r = tserve.load_retriever(art, batch_size=16, mesh=mesh, device=device)
        q = tserve.load_retriever(q_art, batch_size=16, mesh=mesh, device=device)
        out[(d, m)] = (r.recommend(request, k=10), q.recommend(request, k=10),
                       (r.n_users, r.m_items))
    return out


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    import jax

    from gsrs_tpu import serve as jserve
    from gsrs_tpu.config import ModelConfig
    from gsrs_tpu.data.adjacency import build_graph
    from gsrs_tpu.data.synthetic import clustered as jclustered
    from gsrs_tpu.models.registry import build_model
    from gsrs_tpu.ops.ell import ell_from_interactions

    root = tmp_path_factory.mktemp("serve")
    data = jclustered(61, 97, n_clusters=4, seed=1)
    model = build_model(ModelConfig(num_layers=2, embedding_dim=8), build_graph(data),
                        ell=ell_from_interactions(data))
    base = jserve.retriever_from_model(model, model.init_params(jax.random.key(0)), data,
                                       batch_size=16)
    art, q_art = str(root / "emb.npz"), str(root / "q.npz")
    jserve.export_embeddings(base, art)
    jserve.export_embeddings(base, q_art, quantize="int8")
    users = list(range(0, data.n_users, 3))
    return dict(art=art, q_art=q_art, users=users, want=base.recommend(users, k=10),
                n=data.n_users, m=data.m_items)


@pytest.fixture(scope="module")
def ranks(artifacts):
    return spawn(_serve_rank, 4, artifacts["art"], artifacts["q_art"], artifacts["users"],
                 device_type="cpu", timeout_s=300)


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_retriever_matches_jax_single_device(ranks, artifacts, shape):
    items_a, scores_a = artifacts["want"]
    for out in ranks:
        (items_b, scores_b), _, counts = out[shape]
        assert counts == (artifacts["n"], artifacts["m"])
        np.testing.assert_array_equal(items_b, items_a)
        np.testing.assert_allclose(scores_b, scores_a, rtol=0, atol=SCORE_ATOL)
        assert (items_b < artifacts["m"]).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_int8_artifact_scores_as_one_card(ranks, artifacts, shape):
    one = tserve.load_retriever(artifacts["q_art"], batch_size=16, device="cpu")
    items, scores = one.recommend(artifacts["users"], k=10)
    for out in ranks:
        got_items, got_scores = out[shape][1]
        np.testing.assert_array_equal(got_items, items)
        np.testing.assert_array_equal(got_scores, scores)


def test_export_and_query_on_a_model_axis(tmp_path, capfd):
    data = clustered(61, 97, n_clusters=4, seed=2)
    ds = tmp_path / "ds"
    ds.mkdir()
    write_interaction_file(str(ds / "train.txt"), data.train_users, data.train_items)
    ck = str(tmp_path / "ck")
    cli.main(["--data_root", str(tmp_path), "--dataset", "ds", "--layer", "2", "--recdim", "8",
              "--epochs", "1", "--bpr_batch", "64", "--checkpoint_dir", ck, "--tensorboard",
              "0"], device="cpu")
    arts = {}
    for axis in ("1", "2"):
        arts[axis] = str(tmp_path / f"emb{axis}.npz")
        tserve.main(["export", "--checkpoint_dir", ck, "--dataset_dir", str(ds), "--out",
                     arts[axis], "--model_axis", axis, "--device", "cpu"])
    with np.load(arts["1"]) as a, np.load(arts["2"]) as b:
        assert b["user_emb"].shape == (61, 8) and b["item_emb"].shape == (97, 8)
        for name in ("user_emb", "item_emb", "seen_bitset"):
            np.testing.assert_array_equal(b[name], a[name], err_msg=name)
    capfd.readouterr()
    query = ["query", "--artifact", arts["2"], "--users", "0", "5", "60", "--k", "5",
             "--device", "cpu"]
    tserve.main(query)
    one = capfd.readouterr().out
    tserve.main(query + ["--model_axis", "2"])
    two = capfd.readouterr().out
    assert one.count("user ") == 3 and two.strip().endswith(one.strip().splitlines()[-1])
    assert [l for l in two.splitlines() if l.startswith("user ")] == one.strip().splitlines()
