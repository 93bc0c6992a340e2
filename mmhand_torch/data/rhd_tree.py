"""Small RHD-layout crop trees of drawn images, for driving the GAN, HPE
and ratio-study scripts end to end without the real dataset:
``write_rhd_tree`` draws pure noise, ``write_block_tree`` images a GAN can
learn (low-frequency blocks and a textured centre).

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


def write_block_tree(root, n_items: int, size: int = 256) -> str:
    """``n_items`` images of ``size`` px under ``root`` (a multiple of 32),
    the tree mmhand_tpu's bench.py ``_ensure_e2e_tree`` writes (its
    numbers, from seed 1217): 32 x 32 random blocks upsampled, a textured
    centre patch, packed depth in [80, 700) of the same blocks, and each
    image's K, uv_coord, xyz and depth.  A GAN's L1 loss falls on these
    within a few hundred steps; on pure noise it would mean little.  A
    ``.complete_<n>_<size>`` file marks a finished tree, which is then left
    as it is.  Returns ``root`` as a str."""
    root = os.fspath(root)
    done = os.path.join(root, f".complete_{n_items}_{size}")
    if os.path.exists(done):
        return root
    for sub in ("color", "depth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rng = np.random.RandomState(1217)
    annos = {"color": {}, "depth": {}, "mask": {}}
    k_cam = np.array([[283.1, 0.0, size / 2], [0.0, 283.1, size / 2],
                      [0.0, 0.0, 1.0]])
    rep = size // 32
    c0, c1 = size // 4, 3 * size // 4
    for i in range(n_items):
        name = f"{i:05d}.png"
        base = rng.randint(0, 256, (32, 32, 3)).astype(np.int16)
        img = np.repeat(np.repeat(base, rep, 0), rep, 1)
        img[c0:c1, c0:c1] += rng.randint(-24, 24, (c1 - c0, c1 - c0, 3))
        write_png(os.path.join(root, "color", name),
                  np.clip(img, 0, 255).astype(np.uint8))
        dval = rng.randint(80, 700, (32, 32))
        dval = np.repeat(np.repeat(dval, rep, 0), rep, 1)
        write_png(os.path.join(root, "depth", name), np.stack(
            [dval % 256, dval // 256, np.zeros_like(dval)],
            -1).astype(np.uint8))
        rec = {"K": k_cam,
               "uv_coord": rng.uniform(20, size - 20, (21, 2)).astype(
                   np.float32),
               "xyz": rng.uniform(-0.1, 0.6, (21, 3)).astype(np.float32),
               "depth": rng.uniform(100, 650, (21,)).astype(np.float32)}
        for k in annos:
            annos[k][name] = rec
    save_annotations(root, annos)
    with open(done, "w") as fh:
        fh.write("ok\n")
    return root
