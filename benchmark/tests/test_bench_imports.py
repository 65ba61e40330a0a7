"""No module loaded by a run or by the reference has a forbidden top-level
name, compared whole (``gsrs_tpu_torch`` begins with ``gsrs_tpu``); the
reference loads nothing of the program either. Every cell of
BENCHMARK.json runs, and every configuration's reference is loaded."""

import json
import subprocess
import sys

from benchmark.tests.conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "flax", "gsrs_tpu")

RUN = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark.tests.conftest import CELLS, tiny_cell
from benchmark import harness
for name in CELLS:  # traced: the untraced window runs first in each
    harness.run_cell(tiny_cell(name), 7, 0.2, True, "cpu")
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""

REFERENCE = """
import importlib, json, os, pkgutil, sys
sys.path.insert(0, {root!r})
from benchmark import counts, data, reference
from benchmark.tests.conftest import bench
for c in bench()["configs"]:
    with open(os.path.join({root!r}, c["file"])) as f:
        reference.of(json.load(f))
for m in pkgutil.iter_modules(counts.__path__):
    importlib.import_module(f"benchmark.counts.{{m.name}}")
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)], capture_output=True,
                         text=True, timeout=600, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    names = _top_level(RUN)
    assert "gsrs_tpu_torch" in names
    assert not names & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level(REFERENCE)
    assert not names & set(FORBIDDEN + ("gsrs_tpu_torch",))
