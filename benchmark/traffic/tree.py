"""The benchmark's data: an RHD-layout crop tree of images a GAN can learn.

A frozen copy of the program's ``write_block_tree`` (32 x 32 random blocks
upsampled, a textured centre patch, packed depth of the same blocks), with
two changes: each item is drawn from its own stream (seed 1217, item i), so
that a pool of worker processes writes the tree in a few seconds, and the
keypoint depth lies in 0.1-0.7 m, as in RHD's annotations.

The layout is the one the program's RHD readers take: color/<i>.png,
depth/<i>.png (packed depth 256 G + R) and annotation.pickle with K,
uv_coord, xyz and depth for each image, under the folders color, depth and
mask.  The tree is the same for every seed: a run's seed draws the weights,
the pairing and the order in which the tree is read.  A
``.complete_<n>_<size>`` file marks a finished tree, which is then reused.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle

import numpy as np

from benchmark.traffic.png import write_png

TREE_SEED = 1217
FOLDERS = ("color", "depth", "mask")


def item_name(i: int) -> str:
    return f"{i:05d}.png"


def draw_item(i: int, size: int) -> tuple[np.ndarray, np.ndarray, dict]:
    """Item ``i``: its (size, size, 3) uint8 image, its (size, size, 3)
    uint8 packed depth and its annotation record."""
    rng = np.random.RandomState([TREE_SEED, i])
    rep = size // 32
    c0, c1 = size // 4, 3 * size // 4
    margin = min(20, size // 4)
    base = rng.randint(0, 256, (32, 32, 3)).astype(np.int16)
    img = np.repeat(np.repeat(base, rep, 0), rep, 1)
    img[c0:c1, c0:c1] += rng.randint(-24, 24, (c1 - c0, c1 - c0, 3))
    dval = rng.randint(80, 700, (32, 32))
    dval = np.repeat(np.repeat(dval, rep, 0), rep, 1)
    depth = np.stack([dval % 256, dval // 256, np.zeros_like(dval)],
                     -1).astype(np.uint8)
    rec = {"K": np.array([[283.1, 0.0, size / 2], [0.0, 283.1, size / 2],
                          [0.0, 0.0, 1.0]]),
           "uv_coord": rng.uniform(margin, size - margin, (21, 2)).astype(
               np.float32),
           "xyz": rng.uniform(-0.1, 0.6, (21, 3)).astype(np.float32),
           "depth": rng.uniform(0.1, 0.7, (21,)).astype(np.float32)}
    return np.clip(img, 0, 255).astype(np.uint8), depth, rec


def _write_items(args) -> list[tuple[str, dict]]:
    root, size, lo, hi = args
    out = []
    for i in range(lo, hi):
        img, depth, rec = draw_item(i, size)
        name = item_name(i)
        write_png(os.path.join(root, "color", name), img)
        write_png(os.path.join(root, "depth", name), depth)
        out.append((name, rec))
    return out


def write_tree(root: str, n_items: int, size: int = 256,
               workers: int = 6) -> str:
    """The tree of ``n_items`` items of ``size`` px under ``root`` (size a
    multiple of 32), written by ``workers`` processes unless a finished one
    is there.  Returns ``root``."""
    root = os.fspath(root)
    done = os.path.join(root, f".complete_{n_items}_{size}")
    if os.path.exists(done):
        return root
    for sub in ("color", "depth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    chunk = 128
    jobs = [(root, size, lo, min(lo + chunk, n_items))
            for lo in range(0, n_items, chunk)]
    workers = min(workers, len(jobs))
    if workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(workers) as pool:
            parts = pool.map(_write_items, jobs)
            pool.close()
            pool.join()
    else:
        parts = [_write_items(job) for job in jobs]
    annos = {k: {} for k in FOLDERS}
    for part in parts:
        for name, rec in part:
            for k in FOLDERS:
                annos[k][name] = rec
    with open(os.path.join(root, "annotation.pickle"), "wb") as fh:
        pickle.dump(annos, fh)
    with open(done, "w") as fh:
        fh.write("ok\n")
    return root


def load_annotations(root: str) -> dict:
    """The annotation records the tree's writer made (a file this module
    wrote, so unpickling it is safe)."""
    with open(os.path.join(root, "annotation.pickle"), "rb") as fh:
        return pickle.load(fh)
