"""Small raw RHD and STB sources of random frames, in the datasets' own
layouts, for driving the preprocessing (``data.preprocess``) and the chain
after it without the real datasets.

* RHD (the layout of the RHD download): ``<split>/anno_<split>.pickle``
  mapping each frame's index to K, ``uv_vis`` (42, 3) and ``xyz`` (42, 3),
  the left hand's 21 keypoints first, and ``<split>/{color,depth,mask}/
  NNNNN.png``: 320x320 RGB, the depth packed into R (low byte) and G (high
  byte), and a mask with 1 on the person and a hand label on each hand.
  Every frame holds two hands, so the two-hand split and the flip of the
  right hand run.  By the frame's index: every fourth frame from 1 has an
  invisible keypoint on its right hand and every fourth from 2 one on its
  left (that hand is rejected), and every eighth from 7 has a mask of 1
  alone (both crops are dropped as false positives).
* STB: ``labels/<seq>_{SK,BB}.mat`` holding ``handPara`` (3, 21, 1500) in
  mm, and per sequence ``SK_color_<i>.png``, ``BB_left_<i>.png`` and
  ``BB_right_<i>.png``, 640x480 RGB.  The hands lie where all three views
  see every keypoint.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
from PIL import Image

RHD_K = np.array([[614.878, 0.0, 313.219], [0.0, 615.479, 231.288],
                  [0.0, 0.0, 1.0]])


def _save(path: str, img: np.ndarray) -> None:
    Image.fromarray(img).save(path, compress_level=0)


def _hand_box(uv: np.ndarray, shape: tuple[int, int]):
    x0, y0 = np.floor(uv.min(0)).astype(int)
    x1, y1 = np.ceil(uv.max(0)).astype(int)
    return (slice(max(0, y0), min(shape[0], y1 + 1)),
            slice(max(0, x0), min(shape[1], x1 + 1)))


def write_raw_rhd(root, n_frames: int, seed: int = 0,
                  split: str = "evaluation") -> str:
    """``n_frames`` RHD frames under ``root/split``, drawn from ``seed``.
    Returns ``root`` as a str."""
    root = os.fspath(root)
    path = os.path.join(root, split)
    for kind in ("color", "depth", "mask"):
        os.makedirs(os.path.join(path, kind), exist_ok=True)
    rng = np.random.RandomState(seed)
    annos = {}
    for i in range(n_frames):
        name = f"{i:05d}.png"
        centres = rng.uniform(70, 250, (2, 2))
        uv = np.concatenate([c + rng.uniform(-45, 45, (21, 2))
                             for c in centres])
        vis = np.ones((42, 1))
        if i % 4 == 1:
            vis[21 + rng.randint(21)] = 0
        elif i % 4 == 2:
            vis[rng.randint(21)] = 0
        mask = np.ones((320, 320), np.uint8)
        if i % 8 != 7:
            for hand, label in ((uv[:21], 5), (uv[21:], 20)):
                mask[_hand_box(hand, mask.shape)] = label
        packed = rng.randint(0, 1 << 16, (320, 320))
        _save(os.path.join(path, "color", name),
              rng.randint(0, 256, (320, 320, 3)).astype(np.uint8))
        _save(os.path.join(path, "depth", name), np.stack(
            [packed % 256, packed // 256, np.zeros_like(packed)],
            -1).astype(np.uint8))
        _save(os.path.join(path, "mask", name), mask)
        annos[i] = {"K": RHD_K.copy(),
                    "uv_vis": np.concatenate([uv, vis], 1),
                    "xyz": np.concatenate(
                        [rng.uniform(-0.1, 0.1, (42, 2)),
                         rng.uniform(0.3, 0.7, (42, 1))], 1)}
    with open(os.path.join(path, f"anno_{split}.pickle"), "wb") as f:
        pickle.dump(annos, f)
    return root


def write_raw_stb(root, frames: int, seed: int = 0,
                  sequences=("B1Counting", "B4Counting")) -> str:
    """``frames`` frames of each camera view per sequence under ``root``,
    drawn from ``seed``; B4 is STB's test sequence.  Returns ``root`` as a
    str."""
    from scipy.io import savemat

    root = os.fspath(root)
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "labels"), exist_ok=True)
    for seq in sequences:
        os.makedirs(os.path.join(root, seq), exist_ok=True)
        for camera in ("SK", "BB"):
            centre = np.stack([rng.uniform(20, 60, 1500),
                               rng.uniform(-40, 40, 1500),
                               rng.uniform(450, 550, 1500)])
            hand = centre[:, None, :] + rng.uniform(-30, 30, (3, 21, 1500))
            savemat(os.path.join(root, "labels", f"{seq}_{camera}.mat"),
                    {"handPara": hand})
        for view in ("SK_color", "BB_left", "BB_right"):
            for i in range(frames):
                _save(os.path.join(root, seq, f"{view}_{i}.png"),
                      rng.randint(0, 256, (480, 640, 3)).astype(np.uint8))
    return root
