"""MSRA hand depth dataset reader and camera transforms (counterpart of
mmhand_tpu/data/msra.py; the port's own numpy copy).

The parts of reference
baselines/quantitative_on_benchmarks/data/msrahand_dataset.py that the
pose-diversity search and the depth experiments read:

* the packed binary depth format: 6 uint32 header (img_w, img_h, left, top,
  right, bottom) + float32 crop region (:220-245 load_depthmap, without the
  random-rotation augmentation path);
* pixel<->world transforms for the MSRA camera (fx=fy=241.42, 320x240,
  :134-162);
* joint.txt parsing (world-space xyz, 21 joints, y/z sign flip).

The V2V voxelization (:318-493, 651-711) is ``ops.voxelize``; ``voxel_sample``
turns a reader item into its sample.
"""

from __future__ import annotations

import os
import struct

import numpy as np

MSRA_IMG_WIDTH = 320
MSRA_IMG_HEIGHT = 240
MSRA_FX = 241.42
MSRA_FY = 241.42
MSRA_MAX_DEPTH = 700.0
MSRA_GESTURES = ["1", "2", "3", "4", "5", "6", "7", "8", "9",
                 "I", "IP", "L", "MP", "RP", "T", "TIP", "Y"]


def load_depthmap_bin(filename: str, max_depth: float = MSRA_MAX_DEPTH):
    """Read one MSRA .bin depth frame -> (H, W) float32 full-frame depth
    with background at max_depth (reference :220-245, minus the affine
    augmentation).  Returns (depth, (left, top, right, bottom))."""
    with open(filename, "rb") as f:
        data = f.read()
    img_w, img_h, left, top, right, bottom = struct.unpack("I" * 6, data[:24])
    crop = np.frombuffer(data[24:], "<f4").reshape(bottom - top, right - left)
    depth = np.zeros((img_h, img_w), np.float32)
    depth[top:bottom, left:right] = crop
    depth[depth == 0] = max_depth
    return depth, (left, top, right, bottom)


def pixel2world(x, y, z, img_width=MSRA_IMG_WIDTH, img_height=MSRA_IMG_HEIGHT,
                fx=MSRA_FX, fy=MSRA_FY):
    """reference :134-139."""
    w_x = (x - img_width / 2) * z / fx
    w_y = (img_height / 2 - y) * z / fy
    return w_x, w_y, z


def world2pixel(x, y, z, img_width=MSRA_IMG_WIDTH, img_height=MSRA_IMG_HEIGHT,
                fx=MSRA_FX, fy=MSRA_FY):
    """reference :141-147."""
    p_x = x * fx / z + img_width / 2
    p_y = img_height / 2 - y * fy / z
    return p_x, p_y


def read_joints(joint_txt_path: str) -> np.ndarray:
    """Parse joint.txt: first line = frame count, then per frame 21*3
    world-space floats.  MSRA stores y and z negated relative to the
    camera convention used above; returns (N, 21, 3) with the sign fix."""
    with open(joint_txt_path) as f:
        n = int(f.readline().strip())
        vals = np.loadtxt(f, dtype=np.float64)
    joints = vals.reshape(n, 21, 3)
    joints[..., 1] *= -1.0
    joints[..., 2] *= -1.0
    return joints


class MSRAHandDataset:
    """Iterates (depth, xyz world, uv pixel) over the MSRA layout
    P0..P8/<gesture>/{NNNNNN_depth.bin, joint.txt}."""

    def __init__(self, root: str, subjects=None, gestures=None):
        self.root = root
        self.items = []  # (bin_path, xyz)
        subjects = subjects or sorted(
            d for d in os.listdir(root) if d.startswith("P"))
        for subject in subjects:
            for gesture in (gestures or MSRA_GESTURES):
                gdir = os.path.join(root, subject, gesture)
                joint_file = os.path.join(gdir, "joint.txt")
                if not os.path.isfile(joint_file):
                    continue
                joints = read_joints(joint_file)
                for i in range(len(joints)):
                    self.items.append(
                        (os.path.join(gdir, f"{i:06d}_depth.bin"), joints[i]))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> dict:
        path, xyz = self.items[index]
        depth, bbox = load_depthmap_bin(path)
        px, py = world2pixel(xyz[:, 0], xyz[:, 1], xyz[:, 2])
        uv = np.stack([px, py], axis=-1)
        return {"depthmap": depth, "xyz": xyz.astype(np.float32),
                "uv": uv.astype(np.float32), "bbox": bbox, "path": path}


def depthmap2points(depth, fx=MSRA_FX, fy=MSRA_FY):
    """(H, W) depth -> (H*W, 3) world-space point cloud (reference
    :150-156)."""
    h, w = depth.shape
    x, y = np.meshgrid(np.arange(w) + 1, np.arange(h) + 1)
    wx, wy, wz = pixel2world(x, y, depth, w, h, fx, fy)
    return np.stack([wx, wy, wz], axis=-1).reshape(-1, 3).astype(np.float32)


def voxel_sample(item: dict, refpoint=None) -> dict:
    """Reader item -> ``ops.voxelize.V2VVoxelization``'s sample
    {points, keypoints, refpoint} (reference __getitem__ :748-790 role).
    refpoint defaults to the keypoint centroid (the reference loads
    precomputed center files; centroid is the documented fallback)."""
    points = depthmap2points(item["depthmap"])
    points = points[points[:, 2] < MSRA_MAX_DEPTH - 1e-3]
    # a fixed cloud of 32768 points, as mmhand_tpu's static shape: the
    # padding at 1e9 mm falls out of every cube
    n = 32768
    if len(points) >= n:
        points = points[:n]
    else:
        points = np.concatenate(
            [points, np.full((n - len(points), 3), 1e9, np.float32)])
    ref = (np.asarray(refpoint, np.float32) if refpoint is not None
           else item["xyz"].mean(axis=0).astype(np.float32))
    return {"points": points, "keypoints": item["xyz"], "refpoint": ref}
