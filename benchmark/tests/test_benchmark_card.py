"""Each cell's run on the card, short: ``correct`` holds and every metric
of the cell is reported.  Needs a CUDA device; skips without one."""

from __future__ import annotations

import pytest
import torch

from benchmark import run

CELLS = [w["name"] for w in run.load_cell(
    "mmhand_flagship.train").spec["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = run.load_cell(cell)
    result = run.run_cell(c, 4_000_000_007, 8.0, bool(trace))
    assert result["correct"], result["checks"]
    kind = "per_layer" if trace else "end_to_end"
    assert {m["name"] for m in c.metrics(kind)} == set(result["metrics"])
