"""A run of each cell at a small size on the CPU, past the harness's look
for a card, the port in float32 with its kernels' plain versions:
``correct`` holds on the port as it is, and comes out false once the
timed path is broken underneath, once for each fault the cell can have;
the float8 control in the program's place fails the cell's limits too."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from tiny_cells import tiny_cell

from benchmark import run
from benchmark.control import readings

SEED = 3_000_000_019


def correct(cell_name: str) -> bool:
    cell = tiny_cell(cell_name)
    return run.run_cell(cell, SEED, 1.0, False, device="cpu")["correct"]


@pytest.mark.parametrize("cell", ["mmhand_flagship.train", "hpe_hpm.train",
                                  "mmhand_flagship.generate"])
def test_sound_run_is_correct(cell):
    assert correct(cell)


@pytest.mark.parametrize("cell", ["mmhand_flagship.train", "hpe_hpm.train"])
def test_state_left_unchanged(cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None:
                        None)
    assert not correct(cell)


def test_gan_half_batch(monkeypatch):
    from mmhand_torch.train.step import TrainStep

    whole = TrainStep.__call__

    def half(self, batch, lr):
        n = batch["H1"].shape[0] // 2
        return whole(self, {k: v[:n] for k, v in batch.items()}, lr)

    monkeypatch.setattr(TrainStep, "__call__", half)
    assert not correct("mmhand_flagship.train")


def test_hpe_half_batch(monkeypatch):
    import mmhand_torch.hpe as hpe

    make = hpe.make_hpe_train_step

    def make_half(system):
        step = make(system)

        def half(batch, lr):
            n = batch["image"].shape[0] // 2
            return step({k: v[:n] for k, v in batch.items()}, lr)
        return half

    monkeypatch.setattr(hpe, "make_hpe_train_step", make_half)
    assert not correct("hpe_hpm.train")


def test_fake_altered_where_written(monkeypatch):
    import mmhand_torch.utils.png as png

    write = png.write_png
    monkeypatch.setattr(png, "write_png", lambda path, img: write(
        path, np.ascontiguousarray(img[:, ::-1])))
    assert not correct("mmhand_flagship.generate")


def test_fake_never_written(monkeypatch):
    import mmhand_torch.utils.png as png

    write = png.write_png
    monkeypatch.setattr(png, "write_png", lambda path, img: None
                        if path.endswith(("1.png", "3.png", "5.png",
                                          "7.png", "9.png"))
                        else write(path, img))
    assert not correct("mmhand_flagship.generate")


@pytest.mark.parametrize("cell,steps", [("mmhand_flagship.train", 0),
                                        ("hpe_hpm.train", 0),
                                        ("mmhand_flagship.generate", 4)])
def test_float8_control_fails_a_limit(cell, steps):
    c = tiny_cell(cell, "bfloat16")
    control = readings(c, SEED, steps, device="cpu")["fp8"]
    assert any(control[k] > lim for k, lim in c.limits.items()), control
