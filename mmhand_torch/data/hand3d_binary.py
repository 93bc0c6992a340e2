"""hand3d packed-binary GAN database writer and reader (counterpart of
mmhand_tpu/data/hand3d_binary.py; numpy and the port's tracer).

The record format of reference
hand_pose_estimators/CVPR2020_hand3d/data/create_GAN_DB.py:58-120, which
converts MM-Hand synthetic images + txt keypoints into the binary format the
ColorHandPose3D (hand3d) TF stack fine-tunes on.  Record layout:

    42x3 f32  kp_coord_xyz   (21 real + 21 zero padding)
    42x2 f32  kp_coord_uv
    3x3  f32  K
    2x   u8   sentinel (255, 255)
    HxWx3 u8  image (RGB)
    HxW  u8   mask
    42x  u8   visibility

`read_record` matches the WRITER (the reference's own bin_test.py:1-31
forgets the 2 sentinel bytes and reads 42 instead of padded visibility -
not reproduced).  A bad sentinel or a truncated record raises ValueError."""

from __future__ import annotations

import os
import struct

import numpy as np

from mmhand_torch.utils import trace


def add_padding(coords: np.ndarray, total: int = 42) -> np.ndarray:
    """Pad 21 keypoints to 42 rows of zeros (reference :36-40)."""
    coords = np.asarray(coords, np.float32)
    pad = np.zeros((total - coords.shape[0], coords.shape[1]), np.float32)
    return np.concatenate([coords, pad], axis=0)


def write_record(fh, image, mask, kp_coord_xyz, kp_coord_uv, kp_visible,
                 k_mat) -> None:
    """One record (reference write_to_binary :58-101)."""
    xyz = np.asarray(kp_coord_xyz, np.float32)
    uv = np.asarray(kp_coord_uv, np.float32)
    fh.write(xyz.astype("<f4").tobytes())
    fh.write(uv.astype("<f4").tobytes())
    fh.write(np.asarray(k_mat, np.float32).astype("<f4").tobytes())
    fh.write(struct.pack("BB", 255, 255))
    fh.write(np.asarray(image, np.uint8).tobytes())
    fh.write(np.asarray(mask, np.uint8).tobytes())
    fh.write(np.asarray(kp_visible, np.uint8).tobytes())


def record_size(height: int = 256, width: int = 256, n_kp: int = 42) -> int:
    return (n_kp * 3 + n_kp * 2 + 9) * 4 + 2 + height * width * 3 \
        + height * width + n_kp


def read_record(fh, height: int = 256, width: int = 256, n_kp: int = 42):
    """Inverse of write_record."""
    def take(n):
        data = fh.read(n)
        if len(data) != n:
            raise ValueError(f"truncated record: {len(data)} of {n} bytes")
        return data

    xyz = np.frombuffer(take(n_kp * 3 * 4), "<f4").reshape(n_kp, 3)
    uv = np.frombuffer(take(n_kp * 2 * 4), "<f4").reshape(n_kp, 2)
    k = np.frombuffer(take(9 * 4), "<f4").reshape(3, 3)
    sentinel = struct.unpack("BB", take(2))
    if sentinel != (255, 255):
        raise ValueError(f"bad sentinel {sentinel}")
    image = np.frombuffer(take(height * width * 3), np.uint8).reshape(
        height, width, 3)
    mask = np.frombuffer(take(height * width), np.uint8).reshape(height, width)
    vis = np.frombuffer(take(n_kp), np.uint8)
    return {"xyz": xyz, "uv": uv, "K": k, "image": image, "mask": mask,
            "visible": vis}


class Hand3dBinaryDataset:
    """Sequential reader over a packed GAN DB file — the consumer-side
    equivalent of the hand3d TF queue readers (reference
    hand_pose_estimators/CVPR2020_hand3d/data/BinaryDbReader_gan.py role):
    lets the in-framework HPE fine-tune directly from a .bin database.
    Each read is the host span ``hand3d.read`` (``utils.trace``) and adds
    one to the counter ``hand3d.records``."""

    def __init__(self, path: str, height: int = 256, width: int = 256):
        self.path = path
        self.height = height
        self.width = width
        self._rec = record_size(height, width)
        self._len = os.path.getsize(path) // self._rec

    def __len__(self):
        return self._len

    def __getitem__(self, index: int) -> dict:
        with trace.span("hand3d.read"):
            with open(self.path, "rb") as fh:
                fh.seek(index * self._rec)
                record = read_record(fh, self.height, self.width)
        trace.count("hand3d.records")
        return record


def write_gan_db(out_path: str, samples) -> int:
    """samples: iterable of dicts {image (H,W,3) u8, uv (21,2), xyz (21,3),
    K (3,3)}.  Mask defaults to ones, visibility to 1 for the 21 real
    keypoints (reference multitask_handler :104-119)."""
    n = 0
    with open(out_path, "wb") as fh:
        for s in samples:
            image = np.asarray(s["image"], np.uint8)
            mask = s.get("mask")
            if mask is None:
                mask = np.ones(image.shape[:2], np.uint8)
            vis = np.zeros(42, np.uint8)
            vis[:21] = 1
            write_record(fh, image, mask, add_padding(s["xyz"]),
                         add_padding(s["uv"]), vis, s["K"])
            n += 1
    return n
