"""Each driver's plain reference against the port, at a small size on the
CPU, the port in float32 with its kernels' plain versions: the two
compute the same mathematics, so they agree to float32 rounding."""

from __future__ import annotations

import pytest
from tiny_cells import tiny_cell

from benchmark.control import readings

SEED = 2_147_483_659


@pytest.mark.parametrize("cell", ["mmhand_flagship.train", "hpe_hpm.train"])
def test_train_reference_agrees_with_the_port(cell):
    got = readings(tiny_cell(cell), SEED, 0, device="cpu")["program"]
    assert got["loss1_gap"] < 1e-5, got
    assert got["grad_gap_med"] < 1e-5, got
    # the worst leaf's gradient is a sum over the batch that nearly
    # cancels, and Adam's first updates, lr * m / (sqrt(v) + eps), move an
    # element whose gradient is near eps by a share that rounding shifts;
    # the later steps carry those shifts on
    assert got["grad_gap"] < 1e-3, got
    assert got["loss_gap"] < 1e-3, got
    assert got["change_gap"] < 2e-2, got


def test_generation_reference_agrees_with_the_port():
    got = readings(tiny_cell("mmhand_flagship.generate"), SEED, 2,
                   device="cpu")["program"]
    assert got["level_gap"] < 0.01, got
