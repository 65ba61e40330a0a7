"""The harness on the card: short runs of each cell, untraced and traced,
correct, with the device timeline read (marked ``gpu``; skipped without a
card)."""

import pytest

from benchmark import harness
from benchmark.tests.conftest import CELLS


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, trace, cuda_card):
    cell = harness.load_cell(name)
    r = harness.run_cell(cell, 2**31 + 303, 1.0, trace, cuda_card)
    assert r["correct"], r["checks"]
    assert tuple(r["checks"]) == cell.loop.CHECKS
    assert r["device"]["platform"] == "gpu"
    if trace:
        assert r["device"]["busy_s"] > 0
        assert set(r["metrics"]) == {m["name"] for m in cell.per_layer}
