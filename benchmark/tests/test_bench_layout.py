"""BENCHMARK.json resolves to its files by name and keeps to its format's
shapes: names, units, keys, paths and bounds."""

import os
import re

import pytest

from benchmark import harness
from benchmark.tests.conftest import CELLS, ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_paths():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert b["command"][1].startswith("benchmark/")
    assert 1 <= b["run_seconds"] <= 51


def test_the_three_cells():
    assert [w["name"] for w in bench()["workloads"]] == list(CELLS)
    assert all(w["chips"] == 1 for w in bench()["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = harness.load_cell(name, bench())
    assert cell.loop.window and cell.loop.check and cell.loop.control
    assert set(cell.limits) == set(_check_names(cell))
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))
        assert cell.name in m["workloads"]
        assert m["moves"] in names


def _check_names(cell):
    return {"train": ("sampler_invalid", "window_nonfinite", "loss_gap", "grad_gap", "change_gap"),
            "eval": ("rank_gap",),
            "serve": ("rank_gap", "score_gap")}[cell.traffic["loop"]]


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


def test_reduced_matches_the_file_and_counts_are_published():
    for c in bench()["configs"]:
        cfg = harness._json(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == cfg["reduced"]
        assert set(c["reduced"]) <= {"train"}  # never the data's counts or a width
        for key in ("n_users", "m_items", "n_train", "n_test"):
            assert cfg["data"][key] == cfg["published"][key]
        for key in ("num_layers", "embedding_dim"):
            assert cfg["model"][key] == cfg["published"][key]
