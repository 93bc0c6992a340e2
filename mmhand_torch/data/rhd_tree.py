"""A small RHD-layout crop tree of random images, for driving the GAN, HPE
and ratio-study scripts end to end without the real dataset.

The layout is the one ``RHDCrops`` and ``hpe.HPEMixDataset`` read
(reference tool/create_RHD_DB.py:323-355): color/<i>.png, depth/<i>.png
(packed depth 256 G + R) and annotation.pickle with uv_coord, depth
(0.1-0.7), xyz and K for each color image.
"""

from __future__ import annotations

import os

import numpy as np

from mmhand_torch.data.annotations import save_annotations
from mmhand_torch.utils.png import write_png


def write_rhd_tree(root, n: int, size: int, seed: int = 0) -> str:
    """``n`` images of ``size`` px under ``root``, drawn from ``seed``.  The
    names are not zero-padded, so string order and the GAN dataset's
    numeric order differ from 10 images on.  Returns ``root`` as a str."""
    root = os.fspath(root)
    rng = np.random.RandomState(seed)
    for sub in ("color", "depth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    annos = {"color": {}}
    m = min(20, size // 4)
    for i in range(n):
        name = f"{i}.png"
        write_png(os.path.join(root, "color", name),
                  rng.randint(0, 256, (size, size, 3)).astype(np.uint8))
        packed = rng.randint(0, 700, (size, size))
        write_png(os.path.join(root, "depth", name), np.stack(
            [packed % 256, packed // 256, np.zeros_like(packed)],
            -1).astype(np.uint8))
        annos["color"][name] = {
            "uv_coord": rng.uniform(m, size - m, (21, 2)),
            "depth": rng.uniform(0.1, 0.7, (21,)),
            "xyz": rng.uniform(-0.1, 0.1, (21, 3)),
            "K": np.eye(3)}
    save_annotations(root, annos)
    return root
