"""Visualization utilities (counterpart of mmhand_tpu/utils/visualize.py;
reference util/util.py:15-191, models/MMHandModel.py:343-369).

numpy and PIL on the host, the same code as mmhand_tpu's, so a snapshot is
the same PNG in both packages:

* tensor2im: [-1,1] NHWC float -> uint8 RGB.
* map_to_cords: heatmap peak extraction.
* draw_pose_from_map: skeleton render of a 21-channel heatmap, PIL polygons
  in place of the reference's cv2 ellipses.
* seven_tile_strip: the [H1,P1,D1,H2,P2,D2,fake] epoch-snapshot panel.
"""

from __future__ import annotations

import numpy as np


def tensor2im(img) -> np.ndarray:
    """[-1, 1] float (H, W, 3) or (B, H, W, 3) -> uint8, first element if
    batched (reference util/util.py:15-24)."""
    arr = np.asarray(img)
    if arr.ndim == 4:
        arr = arr[0]
    arr = (arr + 1.0) / 2.0 * 255.0
    return np.clip(arr, 0, 255).astype(np.uint8)


def map_to_cords(heatmap, threshold: float = 0.1) -> np.ndarray:
    """Per-channel argmax peak -> (K, 2) (x, y); peaks below threshold get
    (-1, -1) (reference util/util.py:94-114 map_to_cord)."""
    hm = np.asarray(heatmap)
    if hm.ndim == 4:
        hm = hm[0]
    h, w, k = hm.shape
    flat = hm.reshape(-1, k)
    idx = flat.argmax(axis=0)
    ys, xs = np.unravel_index(idx, (h, w))
    peak = flat[idx, np.arange(k)]
    cords = np.stack([xs, ys], axis=-1).astype(np.float32)
    cords[peak < threshold] = -1.0
    return cords


# skeleton bone labels (reference util/util.py:20-90): palm polygon label 1,
# finger bones labels 2..16
_VIS_BONES = [
    ((1, 2), 2), ((2, 3), 3), ((3, 4), 4),
    ((5, 6), 5), ((6, 7), 6), ((7, 8), 7),
    ((9, 10), 8), ((10, 11), 9), ((11, 12), 10),
    ((13, 14), 11), ((14, 15), 12), ((15, 16), 13),
    ((17, 18), 14), ((18, 19), 15), ((19, 20), 16),
]
_PALM_RING = [0, 1, 5, 9, 13, 17]


def labelcolormap(n: int) -> np.ndarray:
    """XOR bit-shuffle label colormap (reference util/util.py:142-167)."""
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        idx = i
        for j in range(7):
            r ^= ((idx >> 0) & 1) << (7 - j)
            g ^= ((idx >> 1) & 1) << (7 - j)
            b ^= ((idx >> 2) & 1) << (7 - j)
            idx >>= 3
        cmap[i] = (r, g, b)
    return cmap


def colorize_labels(gray: np.ndarray, n: int = 22) -> np.ndarray:
    """Label image -> RGB via the XOR colormap (reference Colorize :123-139)."""
    cmap = labelcolormap(n)
    out = np.zeros((*gray.shape, 3), np.uint8)
    for label in range(n):
        out[gray == label] = cmap[label]
    return out


def _ellipse_polygon(mx, my, half_len, radius, angle_rad, steps=360):
    """cv2.ellipse2Poly equivalent: sampled rotated-ellipse boundary."""
    t = np.linspace(0, 2 * np.pi, steps, endpoint=False)
    ex = half_len * np.cos(t)
    ey = radius * np.sin(t)
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    xs = mx + ex * c - ey * s
    ys = my + ex * s + ey * c
    return list(zip(xs.tolist(), ys.tolist()))


def draw_pose_from_cords(cords, img_size, radius: int = 8) -> np.ndarray:
    """Skeleton render: filled palm polygon + rotated-ellipse finger bones,
    colorized by the XOR label colormap
    (reference util/util.py:165-191; PIL polygons replace cv2)."""
    from PIL import Image, ImageDraw

    canvas = Image.new("L", (img_size[1], img_size[0]), 0)
    draw = ImageDraw.Draw(canvas)
    palm = [(float(cords[i][0]), float(cords[i][1])) for i in _PALM_RING
            if cords[i][0] >= 0]
    if len(palm) >= 3:
        draw.polygon(palm, fill=1)
    for (a, b), label in _VIS_BONES:
        p0, p1 = cords[a], cords[b]
        if p0[0] < 0 or p1[0] < 0:
            continue
        mx, my = (p0[0] + p1[0]) / 2, (p0[1] + p1[1]) / 2
        length = float(np.hypot(p0[0] - p1[0], p0[1] - p1[1]))
        angle = float(np.arctan2(p0[1] - p1[1], p0[0] - p1[0]))
        draw.polygon(_ellipse_polygon(mx, my, max(length / 2, 1), radius,
                                      angle), fill=label)
    return colorize_labels(np.asarray(canvas), 22)


def draw_pose_from_map(heatmap, threshold: float = 0.1) -> np.ndarray:
    """Skeleton visualization of a 21-channel heatmap (uint8 RGB)
    (reference util/util.py:116-121)."""
    hm = np.asarray(heatmap)
    if hm.ndim == 4:
        hm = hm[0]
    cords = map_to_cords(hm, threshold)
    return draw_pose_from_cords(cords, hm.shape[:2])


def seven_tile_strip(h1, p1, d1, h2, p2, d2, fake) -> np.ndarray:
    """[H1, P1, D1, H2, P2, D2, fake] panel
    (reference MMHandModel.py:343-369)."""
    tiles = [tensor2im(h1), draw_pose_from_map(p1), tensor2im(d1),
             tensor2im(h2), draw_pose_from_map(p2), tensor2im(d2),
             tensor2im(fake)]
    return np.concatenate(tiles, axis=1)
