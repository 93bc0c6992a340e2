"""Ratio-mixing dataset of the augmentation study (counterpart of
mmhand_tpu/hpe/data.py; reference hand_pose_estimators/CVPR2020_hpm3d/data/
RHD_dataset.py).

At init a (1-ratio) share of the train images is marked augmented; those
load from the sibling directory "{method}_{last-dir-of-dataroot}", the
output tree of ``mmhand_torch.scripts.aug``, or, for method "None", become
random noise with instance weight 0 (the ablation, RHD_dataset.py:145-148).
Heatmaps use sigma 5 here (:157), against sigma 6 in the GAN data path; z
targets are depth / 0.7 (:158).

Deliberate divergence against mmhand_tpu: the augmentation map.  mmhand_tpu
(and the reference) mark a seeded random (1-ratio) share of the
string-sorted paths, while ``aug`` writes the targets of the GAN dataset's
own split with is_train False (``split_src_tgt``: the first (1-ratio) share
in its sort order), so a marked image may have no generated file.  Here the
marked images are exactly those targets, taken from the GAN dataset itself
(``data.build_dataset``).  The count is the same.

The host supplies raw records; ``make_hpe_prepare_batch`` renders the
heatmaps (kernel K1 on a CUDA device) and normalizes on the device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mmhand_torch.config import Config
from mmhand_torch.data.datasets import build_dataset
from mmhand_torch.ops.heatmap import gaussian_heatmaps
from mmhand_torch.ops.image import normalize_image
from mmhand_torch.utils import trace

HPE_SIGMA = 5.0   # reference RHD_dataset.py:157
Z_SCALE = 0.7     # reference RHD_dataset.py:158 depth/0.7


def augmentation_dir_for(dataroot: str, method: str) -> str:
    """Sibling dir '{method}_{leaf}' (reference RHD_dataset.py:107-110)."""
    root = os.path.normpath(dataroot)
    parent, leaf = os.path.split(root)
    return os.path.join(parent, f"{method}_{leaf}")


def _read_rgb(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.uint8)


class HPEMixDataset:
    """Single-image items over an RHD/STB crop tree with real/synthetic
    mixing.  The listing is the GAN dataset's (color images only), sorted
    as strings, as in mmhand_tpu.

    ``augmented_reads`` counts the images read from the augmentation
    directory."""

    def __init__(self, cfg: Config, is_train: bool = True,
                 length_for_synthetic: int = 64):
        self.cfg = cfg
        self.is_train = is_train
        self.size = cfg.model.fine_size
        self.method = cfg.data.augmentation_method
        # draws the noise images of method "None"
        self.rng = np.random.default_rng(cfg.data.seed)
        self.augmented_reads = 0

        name = cfg.data.dataset.lower()
        if name == "synthetic":
            self.paths = [f"synthetic://{i:05d}.png"
                          for i in range(length_for_synthetic)]
            self.annotations = None
            aug_written = []  # no image is read from disk
        elif name in ("rhd", "stb"):
            # the GAN dataset's listing and its generate-mode split: its
            # targets are the images ``aug`` writes
            gan = build_dataset(cfg.replace(is_train=False))
            self.annotations = gan.annotations
            self.paths = sorted(gan.image_paths)
            aug_written = gan.image_target
        else:
            raise ValueError(f"HPEMixDataset: unknown dataset "
                             f"[{cfg.data.dataset}]")

        self.augmentation_map = np.zeros(len(self.paths), bool)
        # at ratio 1.0 the study generates nothing (its driver runs no aug)
        if is_train and cfg.data.augmentation_ratio < 1.0:
            self.augmentation_dir = augmentation_dir_for(
                cfg.data.dataroot or "synthetic", self.method)
            marked = set(aug_written)
            self.augmentation_map[:] = [p in marked for p in self.paths]

    def __len__(self):
        return len(self.paths)

    def update_parameters(self):
        """Curriculum hook (reference data/base_dataset.py:62-67, called
        every 5 epochs from train.py:89-91): each `updatable_<name>`
        attribute is bumped by the matching `step_<name>`.  The reference's
        only consumer is the MSRA rotation-augmentation curriculum
        (msrahand_dataset.py:740-741); any subclass/instance attr pair
        participates here the same way."""
        for k, v in list(self.__dict__.items()):
            parts = k.split("_")
            if parts[0] == "updatable":
                setattr(self, k,
                        v + getattr(self, "step_" + "_".join(parts[1:])))

    def _labels(self, path: str):
        if self.annotations is None:
            # Python salts str hashes per process (PYTHONHASHSEED), so the
            # synthetic labels and images repeat only within one process,
            # as in mmhand_tpu
            rng = np.random.default_rng(abs(hash(path)) % (2 ** 63))
            m = min(20, self.size // 4)
            return {"uv_coord": rng.uniform(m, self.size - m, (21, 2)),
                    "depth": rng.uniform(0.1, 0.7, (21,))}
        folder, name = path.split(os.sep)[-2], os.path.basename(path)
        return self.annotations[folder][name]

    def load_item(self, index: int) -> dict:
        path = self.paths[index]
        labels = self._labels(path)
        weight = 1
        if self.annotations is None:
            rng = np.random.default_rng(abs(hash(path)) % (2 ** 63) + 1)
            image = rng.integers(0, 256, (self.size, self.size, 3), np.uint8)
        elif self.is_train and self.augmentation_map[index]:
            if self.method == "None":
                # noise ablation sample (reference RHD_dataset.py:145-148)
                image = (self.rng.random((self.size, self.size, 3))
                         * 255).astype(np.uint8)
                weight = 0
            else:
                folder = path.split(os.sep)[-2]
                name = os.path.basename(path)
                image = _read_rgb(os.path.join(self.augmentation_dir, folder,
                                               name))
                self.augmented_reads += 1
        else:
            image = _read_rgb(path)
        return {
            "image": image,
            "uv": np.asarray(labels["uv_coord"], np.float32),
            "z": np.asarray(labels["depth"], np.float32) / Z_SCALE,
            "weight": np.int32(weight),
            "path": path,
        }

    def batch(self, indices) -> dict:
        """The items of ``indices`` stacked; their reads are the span
        ``hpe.decode`` (``utils.trace``)."""
        with trace.span("hpe.decode"):
            items = [self.load_item(int(i)) for i in indices]
        return {
            "image": np.stack([it["image"] for it in items]),
            "uv": np.stack([it["uv"] for it in items]),
            "z": np.stack([it["z"] for it in items]),
            "weight": np.stack([it["weight"] for it in items]),
        }


class BinDBDataset:
    """HPE training batches straight from a hand3d packed binary GAN DB
    (``mmhand_torch.data.hand3d_binary``; scripts/create_hand3d_db.py
    writes one): the in-framework replacement for the reference's TF
    BinaryDbReader_gan fine-tuning path."""

    def __init__(self, bin_path: str, size: int = 256):
        from mmhand_torch.data.hand3d_binary import Hand3dBinaryDataset

        self.db = Hand3dBinaryDataset(bin_path, size, size)
        self.size = size

    def __len__(self):
        return len(self.db)

    def batch(self, indices) -> dict:
        recs = [self.db[int(i)] for i in indices]
        return {
            "image": np.stack([r["image"] for r in recs]),
            "uv": np.stack([r["uv"][:21] for r in recs]).astype(np.float32),
            "z": np.stack([r["xyz"][:21, 2] for r in recs]).astype(
                np.float32) / Z_SCALE,
            "weight": np.ones(len(recs), np.int32),
        }


def make_hpe_prepare_batch(sigma: float = HPE_SIGMA, device="cuda"):
    """Raw host batch -> batch on ``device``: image in [-1, 1], the
    sigma-5 heatmaps (B, S, S, 21) (kernel K1 on a CUDA device), z float32,
    weight int32."""
    device = torch.device(device)

    def to_device(a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype)).to(device)

    def prepare(raw: dict) -> dict:
        image = to_device(raw["image"])
        size = image.shape[1]
        return {
            "image": normalize_image(image),
            "heatmaps": gaussian_heatmaps(to_device(raw["uv"], np.float32),
                                          size, size, sigma),
            "z": to_device(raw["z"], np.float32),
            "weight": to_device(raw["weight"], np.int32),
        }

    return prepare
