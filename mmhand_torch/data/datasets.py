"""Paired hand datasets over preprocessed crop trees
(counterpart of mmhand_tpu/data/datasets.py).

The host does PIL decode and annotation lookup only; normalization, heatmaps
and depth planes are rendered on the device by ``loader.make_prepare_batch``.

Item contract (raw host record):
  image  uint8  (S, S, 3)  RGB
  depth  uint16 (S, S)     packed GAN depth value 256*G + R (pre-/700)
  uv     float32 (21, 2)
  z      float32 (21,)     keypoint depth (raw)
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

import numpy as np

from mmhand_torch.config import Config
from mmhand_torch.data.annotations import load_annotations, split_src_tgt
from mmhand_torch.data.csv_dataset import MMHandCSVDataset


@dataclass
class RawItem:
    image: np.ndarray
    depth: np.ndarray
    uv: np.ndarray
    z: np.ndarray
    path: str


def _decode_image(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.uint8)


def _decode_depth_packed(path: str) -> np.ndarray:
    """Packed GAN depth 256*G + R as uint16
    (reference generic_dataset.py:148-153, RGB order — see ops.depth)."""
    from PIL import Image

    rgb = np.asarray(Image.open(path).convert("RGB"), np.float32)
    return (256.0 * rgb[..., 1] + rgb[..., 0]).astype(np.uint16)


class PairedHandDataset:
    """Base paired dataset (reference data/generic_dataset.py:81-180)."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.root_dir = cfg.data.dataroot
        self.annotations = load_annotations(self.root_dir)
        self.rng = np.random.default_rng(cfg.data.seed)
        # every listed image, in listing order
        self.image_paths = self._list_images()
        self.image_source, self.image_target = split_src_tgt(
            self.image_paths, cfg.data.augmentation_ratio,
            is_train=cfg.is_train, root_dir=self.root_dir,
            rng=self.rng, sort_fn=self._sort_key)

    # --- subclass hooks -----------------------------------------------
    def _list_images(self) -> list:
        raise NotImplementedError

    def _sort_key(self, path: str):
        raise NotImplementedError

    def _label_key(self, path: str):
        """(folder, name) key into the annotation dict
        (reference generic_dataset.py:201-206)."""
        folder, name = path.split(os.sep)[-2], os.path.basename(path)
        return folder, name

    # --- access ---------------------------------------------------------
    def __len__(self):
        return len(self.image_source)

    def get_labels(self, path: str) -> dict:
        folder, name = self._label_key(path)
        return self.annotations[folder][name]

    def load_raw(self, path: str) -> RawItem:
        anno = self.get_labels(path)
        image = _decode_image(path)
        depth = _decode_depth_packed(path.replace("color", "depth"))
        uv = np.asarray(anno["uv_coord"], np.float32)
        z = np.asarray(anno["depth"], np.float32)
        return RawItem(image=image, depth=depth, uv=uv, z=z, path=path)

    def load_pair(self, index: int):
        """(source, target) raw items — H1/P1/D1 come from source, H2/P2/D2
        from target (reference generic_dataset.py:133-180)."""
        return (self.load_raw(self.image_source[index]),
                self.load_raw(self.image_target[index]))


class RHDCrops(PairedHandDataset):
    """RHD crop tree (reference data/rhd_dataset.py:16-43): annotation folders
    {color, depth, mask}; color images are the base list, sorted numerically."""

    def _list_images(self) -> list:
        return [os.path.join(self.root_dir, "color", image)
                for image in self.annotations.get("color", {})]

    def _sort_key(self, path: str):
        stem = os.path.basename(path).rsplit(".", 1)[0]
        m = re.match(r"(\d+)", stem)
        return (int(m.group(1)) if m else 0, stem)


class STBCrops(PairedHandDataset):
    """STB crop tree (reference data/stb_dataset.py:15-43): per-sequence
    folders (B1Counting, ...); keep only SK color frames; sort by
    (folder number, Counting/Random, frame)."""

    def _list_images(self) -> list:
        out = []
        for folder, images in self.annotations.items():
            for image in images:
                parts = image.split("_")
                if len(parts) >= 3 and parts[0] != "BB" and parts[1] == "color":
                    out.append(os.path.join(self.root_dir, folder, image))
        return out

    def _sort_key(self, path: str):
        folder = path.split(os.sep)[-2]
        name = os.path.basename(path)
        frame = int(name.rsplit(".", 1)[0].split("_")[-1])
        return int(folder[1]), folder[2], frame


class SyntheticHands:
    """Random dataset shaped like RHD-256: runs the whole pipeline with no
    data on disk.  Its numpy draws are those of mmhand_tpu's SyntheticHands,
    so both packages see the same raw batches for the same seed."""

    def __init__(self, cfg: Config, length: int = 256):
        self.cfg = cfg
        self.size = cfg.model.fine_size
        self._len = length
        self.image_source = [f"synthetic://{i}" for i in range(length)]
        self.image_target = list(self.image_source)

    def __len__(self):
        return self._len

    def load_pair(self, index: int):
        s = self.size
        rng = np.random.default_rng(
            (self.cfg.data.seed * 1_000_003 + index) % (2 ** 63))

        margin = min(20, s // 4)

        def item(tag):
            return RawItem(
                image=rng.integers(0, 256, (s, s, 3), np.uint8,
                                   endpoint=False),
                depth=rng.integers(0, 700, (s, s)).astype(np.uint16),
                uv=rng.uniform(margin, s - margin, (21, 2)).astype(np.float32),
                z=rng.uniform(100, 650, (21,)).astype(np.float32),
                path=f"synthetic://{tag}/{index:05d}.png")

        return item("src"), item("tgt")


def build_dataset(cfg: Config):
    """Dataset factory (reference data/mmhand_dataset_data_loader.py:12-17)."""
    name = cfg.data.dataset.lower()
    if name == "rhd":
        return RHDCrops(cfg)
    if name == "stb":
        return STBCrops(cfg)
    if name == "synthetic":
        return SyntheticHands(cfg)
    if name == "mmhand":
        return MMHandCSVDataset.from_config(cfg)
    raise ValueError(f"unknown dataset [{cfg.data.dataset}]")
