"""A cell is added by new files and new BENCHMARK.json entries alone: in a
copy of the benchmark, a fourth cell made of a ``workloads`` entry, a mix
that names an existing loop and overrides a section of its configuration,
the cell's limits and its name in the workloads of the metrics it reports
is resolved, sized by its loop, run correct on the CPU and checked by
every cross-cell test, and no file that was copied is edited."""

import copy
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET

from benchmark import harness
from benchmark.tests.conftest import ROOT, bench, cells_of

NEW = "added-cell"
MIX = "added-mix"


def _digests(top: str) -> dict:
    out = {}
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, top)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _with_new_cell(b: dict, like: str) -> dict:
    """BENCHMARK.json with the cell ``NEW`` added: the configuration of
    cell ``like`` under ``MIX``, reporting the metrics ``like`` reports."""
    b = copy.deepcopy(b)
    w = next(w for w in b["workloads"] if w["name"] == like)
    b["workloads"].append(dict(w, name=NEW, traffic=MIX, why="a cell added as data alone"))
    for m in b["end_to_end"] + b["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(NEW)
    return b


def _copied_harness(root, monkeypatch):
    """The copy's ``harness`` module: it finds a cell's files under ``root``."""
    spec = importlib.util.spec_from_file_location("copied_harness",
                                                  os.path.join(root, "benchmark", "harness.py"))
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, mod)
    spec.loader.exec_module(mod)
    return mod


def test_a_cell_added_as_data_alone_is_run_and_checked(tmp_path, monkeypatch):
    like = cells_of("eval")[0]
    cell = harness.load_cell(like, bench())
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    copied = _digests(tmp_path / "benchmark")

    mix_name = next(w["traffic"] for w in bench()["workloads"] if w["name"] == like)
    mix = harness._json(os.path.join(ROOT, "benchmark", "traffic", f"{mix_name}.json"))
    k = max(cell.cfg["eval"]["topks"]) // 2  # an override the tiny size keeps
    mix["overrides"] = dict(mix.get("overrides", {}), eval={"topks": [k]})
    (tmp_path / "benchmark" / "traffic" / f"{MIX}.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark" / "limits" / f"{NEW}.json").write_text(json.dumps(cell.limits))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(_with_new_cell(bench(), like)))
    assert _copied_harness(tmp_path, monkeypatch).load_cell(NEW).cfg["eval"]["topks"] == [k]

    xml = tmp_path / "run.xml"
    path = [str(tmp_path), ROOT] + os.environ.get("PYTHONPATH", "").split(os.pathsep)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, path)),
               PYTHONDONTWRITEBYTECODE="1")
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "benchmark/tests", "-q", "-p", "no:cacheprovider",
         "-k", f"test_bench_layout or {NEW}", f"--junitxml={xml}"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
    ran = {case.get("name"): case.find("skipped") is None
           for case in ET.parse(xml).iter("testcase")}
    for test in ("test_cell_resolves_to_its_files[{}]",
                 "test_every_cell_runs_correct_on_the_cpu[{}-False]",
                 "test_every_cell_runs_correct_on_the_cpu[{}-True]",
                 "test_the_control_fails_a_limit[{}]",
                 "test_an_eval_answer_altered[{}]",
                 "test_reduced_matches_the_file_and_counts_are_published"):
        assert ran.get(test.format(NEW)), (test, ran)

    after = _digests(tmp_path / "benchmark")
    assert {f: after[f] for f in copied} == copied
    assert set(after) - set(copied) == {f"traffic/{MIX}.json", f"limits/{NEW}.json"}
