"""BENCHMARK.json resolves to its files by name and keeps to its format's
shapes: names, units, keys, paths and bounds."""

import os
import re

import pytest

from benchmark import harness, reference
from benchmark.tests.conftest import CELLS, ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# what a loop declares: its checks' names, its tiny size, and a run's steps
LOOP = ("tiny", "make_inputs", "setup", "window", "observe", "check", "control")
# a width, never cut: a hidden, intermediate, latent, state or projection
# size, a head size, an expansion factor, the experts per token
WIDTH = re.compile(r"(_dim|_rank)$|^d_|hidden|intermediate|latent|state|proj|head_size|expan"
                   r"|mult|per_tok")


def test_top_level_keys_and_paths():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert b["command"][1].startswith("benchmark/")
    assert 1 <= b["run_seconds"] <= 51


def test_every_cell_asks_for_one_or_four_chips():
    cells = bench()["workloads"]
    assert all(w["chips"] in (1, 4) for w in cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


def test_cells_and_configurations_pair_once():
    b = bench()
    cells = b["workloads"]
    assert 1 <= len(cells) <= 24 and 1 <= len(b["configs"]) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(set(pairs)) == len(pairs)
    assert {c["name"] for c in b["configs"]} == {w["config"] for w in cells}


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = harness.load_cell(name, bench())
    for part in LOOP:
        assert callable(getattr(cell.loop, part)), part
    assert set(cell.limits) == set(cell.loop.CHECKS)
    assert reference.of(cell.cfg)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))
        assert cell.name in m["workloads"]
        assert m["moves"] in names


def test_names_units_and_keys():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("benchmark/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                     "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in b["per_layer"]:
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def cut_faults(cfg: dict) -> list:
    """What a configuration file breaks of the rule on cuts: a key of its
    ``data`` or ``model`` that ``published`` also holds differs from it
    unless ``reduced`` lists it; a key cut there is no width, and the file
    states beside it the published value (``published``) and the
    deployment it stands for (``deployment``). A group changed as a whole
    is named by its top-level key (``train``)."""
    reduced, published = cfg["reduced"], cfg["published"]
    faults = []
    for section in ("data", "model"):
        for key, value in cfg.get(section, {}).items():
            if key in published and key not in reduced and value != published[key]:
                faults.append(f"{section}.{key} is not the published value, nor in reduced")
    for key in reduced:
        if not any(key in cfg.get(section, {}) for section in ("data", "model")):
            continue
        if WIDTH.search(key):
            faults.append(f"{key} is a width")
        if key not in published:
            faults.append(f"{key} is cut without its published value")
        if not cfg.get("deployment", {}).get(key):
            faults.append(f"{key} is cut without the deployment it stands for")
    return faults


def test_reduced_matches_the_file_and_counts_are_published():
    for c in bench()["configs"]:
        cfg = harness._json(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == cfg["reduced"]
        assert cut_faults(cfg) == [], c["name"]


PUBLISHED = {"n_users": 1000, "m_items": 800, "num_layers": 4, "embedding_dim": 64}


@pytest.mark.parametrize("cut, reduced, deployment, faults", [
    ({}, [], {}, 0),
    ({"train": {"batch_size": 8}}, ["train"], {}, 0),
    ({"data": {"m_items": 100}}, ["m_items"], {"m_items": "an eighth of the catalog"}, 0),
    ({"model": {"num_layers": 2}}, ["num_layers"], {"num_layers": "two stages of two"}, 0),
    ({"data": {"m_items": 100}}, [], {}, 1),
    ({"data": {"m_items": 100}}, ["m_items"], {}, 1),
    ({"model": {"embedding_dim": 32}}, ["embedding_dim"], {"embedding_dim": "half"}, 1),
    ({"model": {"hidden_size": 32}}, ["hidden_size"], {"hidden_size": "half"}, 2),
], ids=["whole", "a-group", "a-count", "depth", "unlisted", "no-deployment", "a-width",
        "an-unpublished-width"])
def test_the_rule_on_cuts(cut, reduced, deployment, faults):
    cfg = {"published": dict(PUBLISHED),
           "data": {"n_users": 1000, "m_items": 800, "zipf_s": 1.1},
           "model": {"num_layers": 4, "embedding_dim": 64},
           "train": {"batch_size": 2048}, "reduced": reduced, "deployment": deployment}
    for section, values in cut.items():
        cfg[section] = dict(cfg[section], **values)
    assert len(cut_faults(cfg)) == faults, cut_faults(cfg)
