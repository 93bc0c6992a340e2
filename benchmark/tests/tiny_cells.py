"""The benchmark's cells cut to a size the CPU tests can run: the nets at
their published widths and depths on 32 px images, batch 2 (the GAN) or
4 (the HPE nets), trees of 32 items in a temporary cache."""

from __future__ import annotations

import copy

from benchmark import run

def tiny_cell(name: str, compute_dtype: str = "float32") -> run.Cell:
    cell = copy.deepcopy(run.load_cell(name))
    cfg = cell.config
    if "variant" in cfg:
        cfg["model"] = {"fine_size": 32}
        cfg["batch_size"] = 4
    else:
        cfg["model"] = {**cfg["model"], "fine_size": 32}
        cfg["batch_size"] = 2
    cfg["precision"]["compute_dtype"] = compute_dtype
    cell.traffic["tree_items"] = 32
    return cell
