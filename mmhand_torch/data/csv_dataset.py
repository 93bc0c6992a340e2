"""The PATN-style CSV pair dataset and its pose maps (counterpart of
mmhand_tpu/data/csv_dataset.py).

* ``MMHandCSVDataset`` (reference data/mmhand_dataset.py:14-118): a pair
  list CSV (from,to); per image the PNG, its prerendered 21-channel pose
  map ``.npy`` and its depth image; an optional left-right flip.  Train
  mode gives each index a random pair (reference :45-46), so an epoch is
  statistical.
* ``cords_to_map`` / ``compute_pose_maps`` (reference
  tool/generate_pose_map_RHD.py:22-50 and its four near copies): a
  ``name:keypoints_y:keypoints_x`` CSV of JSON lists to sigma-6 Gaussian
  ``.npy`` maps, skipping keypoints at ``MISSING_VALUE``.

The naming contract of the chain: a pose map is ``<pose root>/<phase>P/
<name>.npy`` with ``<name>`` the pair list's name as it stands, extension
included (``color/00000.png`` -> ``color/00000.png.npy``), as in the
reference's PATN convention.  The port's ``export_baseline_formats
keypoints`` writes the names so.  The depth image of ``<image root>/
<phase>/<name>`` is ``<image root>/<phase>/<name>`` with every ``color``
of the name made ``depth`` (``color/00000.png`` -> ``depth/00000.png``,
``B1Counting/SK_color_3.png`` -> ``B1Counting/SK_depth_3.png``), as the
reference does; a ``color`` in the image root itself stays.  The CSVs are
read with the stdlib ``csv`` module.
"""

from __future__ import annotations

import csv
import json
import os
import random
from typing import Optional

import numpy as np
from PIL import Image

MISSING_VALUE = -1


def cords_to_map(cords, img_size=(256, 256), sigma: float = 6.0) -> np.ndarray:
    """(K, 2) (y, x) keypoints -> (H, W, K) float32 Gaussian maps
    (reference generate_pose_map_RHD.py:22-29).  Unlike the heatmaps of the
    GAN loader (kernel K1), nothing is clipped."""
    cords = np.asarray(cords, np.float64)
    h, w = img_size
    result = np.zeros((h, w, cords.shape[0]), np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    for i, (cy, cx) in enumerate(cords):
        if cy == MISSING_VALUE or cx == MISSING_VALUE:
            continue
        result[..., i] = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                / (2 * sigma ** 2))
    return result


def load_pose_cords_from_strings(y_str: str, x_str: str) -> np.ndarray:
    """JSON '[y...]' and '[x...]' -> (K, 2) (y, x)
    (reference generate_pose_map_RHD.py:16-20)."""
    y = json.loads(y_str)
    x = json.loads(x_str)
    return np.stack([np.asarray(y), np.asarray(x)], axis=1)


def read_csv_rows(path: str, sep: str = ",") -> list[dict]:
    """The rows of a CSV with a header line, as dicts of strings."""
    with open(path, newline="") as f:
        return list(csv.DictReader(f, delimiter=sep))


def compute_pose_maps(annotations_csv: str, save_path: str,
                      img_size=(256, 256), sigma: float = 6.0,
                      sep: str = ":") -> int:
    """Render one ``<save_path>/<name>.npy`` per row of a keypoint CSV
    (reference generate_pose_map_*.py compute_pose); returns the count."""
    rows = read_csv_rows(annotations_csv, sep)
    os.makedirs(save_path, exist_ok=True)
    for row in rows:
        cords = load_pose_cords_from_strings(row["keypoints_y"],
                                             row["keypoints_x"])
        out = os.path.join(save_path, row["name"] + ".npy")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        np.save(out, cords_to_map(cords, img_size, sigma))
    return len(rows)


def depth_path(dir_h: str, image: str) -> str:
    """The depth image of ``dir_h/image``: every ``color`` of the relative
    name ``image`` becomes ``depth`` (the reference's rule); ``dir_h``
    stays as it is.  Raises when the name holds no ``color``, where the
    rule would give the image itself."""
    if "color" not in image:
        raise ValueError(f"{image!r} names no color image: no depth image "
                         "to pair with it")
    return os.path.join(dir_h, image.replace("color", "depth"))


class MMHandCSVDataset:
    """Paired dataset over a CSV pair list and prerendered pose maps.

    ``prerendered = True`` tells ``HostLoader`` that items are already the
    float32 H1..D2 arrays (the pose maps come from ``.npy``; the depth is an
    RGB image normalized like the hand image, reference
    data/mmhand_dataset.py:73-106), so ``make_prepare_batch`` only copies
    them to the device.

    In train mode, index ``i`` of an epoch takes the ``i``-th (pair, flip)
    draw of that epoch's stream, ``random.Random(f"{seed}:{epoch}")``,
    drawn in index order when ``set_epoch`` is called (``HostLoader`` calls
    it before each epoch).  An item is then a function of (seed, epoch,
    index) alone: the loader's threads cannot reorder the draws, a resumed
    run draws what the first run drew, and ranks, which read disjoint
    shards of the indices, draw different pairs.  Before any
    ``set_epoch`` the stream is ``random.Random(seed)``, so items 0, 1,
    2, ... are the ones mmhand_tpu's dataset gives on its first calls with
    the same seed, flips included.
    """

    prerendered = True

    def __init__(self, image_root: str, pose_root: str, pair_lst: str,
                 phase: str = "train", use_flip: bool = False,
                 seed: Optional[int] = None):
        self.dir_h = os.path.join(image_root, phase)
        self.dir_p = os.path.join(pose_root, phase + "P")
        self.phase = phase
        self.use_flip = use_flip
        self.seed = seed
        self.pairs = [[row["from"], row["to"]]
                      for row in read_csv_rows(pair_lst)]
        self.set_epoch(None)

    @classmethod
    def from_config(cls, cfg) -> "MMHandCSVDataset":
        """From the Config flags --imageroot, --poseroot, --pairLst,
        --use_flip and --phase (reference
        data/mmhand_dataset_data_loader.py:12-17, options/base_options.py:
        16-19,126-128)."""
        if not cfg.data.pair_lst:
            raise ValueError("--dataset MMHand requires --pairLst")
        return cls(image_root=cfg.data.image_root or cfg.data.dataroot,
                   pose_root=cfg.data.pose_root or cfg.data.dataroot,
                   pair_lst=cfg.data.pair_lst,
                   phase=cfg.run.phase if not cfg.is_train else "train",
                   use_flip=cfg.data.use_flip,
                   seed=cfg.data.seed)

    def __len__(self):
        return len(self.pairs)

    def set_epoch(self, epoch: Optional[int]) -> None:
        """Draw every index's (pair, flip) of ``epoch`` in train mode; None
        is the plain ``random.Random(seed)`` stream."""
        if self.phase != "train":
            return
        key = self.seed if epoch is None or self.seed is None \
            else f"{self.seed}:{epoch}"
        rng = random.Random(key)
        n = len(self.pairs)
        # the pair, then the flip only when flips are on: mmhand_tpu's
        # order of draws
        self._draws = [(rng.randint(0, n - 1),
                        self.use_flip and rng.uniform(0, 1) > 0.5)
                       for _ in range(n)]

    def _paths(self, name: str):
        img = name if name.endswith(".png") else name + ".png"
        return (os.path.join(self.dir_h, img),
                os.path.join(self.dir_p, name + ".npy"),
                depth_path(self.dir_h, img))

    def __getitem__(self, index: int) -> dict:
        flip = False
        if self.phase == "train":
            # a statistical epoch: a random pair per index (reference :45-46)
            index, flip = self._draws[index]
        h1_name, h2_name = self.pairs[index]

        def load(name):
            h_path, p_path, d_path = self._paths(name)
            img = np.asarray(Image.open(h_path).convert("RGB"), np.uint8)
            pose = np.load(p_path).astype(np.float32)  # (H, W, K)
            depth = np.asarray(Image.open(d_path).convert("RGB"), np.uint8)
            return img, pose, depth

        h1, p1, d1 = load(h1_name)
        h2, p2, d2 = load(h2_name)

        if flip:
            h1, h2 = h1[:, ::-1], h2[:, ::-1]
            p1, p2 = p1[:, ::-1], p2[:, ::-1]
            d1, d2 = d1[:, ::-1], d2[:, ::-1]

        def norm(img):
            return ((np.asarray(img, np.float32) / 255.0) - 0.5) / 0.5

        return {
            "H1": norm(h1), "P1": np.ascontiguousarray(p1), "D1": norm(d1),
            "H2": norm(h2), "P2": np.ascontiguousarray(p2), "D2": norm(d2),
            "H1_path": h1_name, "H2_path": h2_name,
        }
