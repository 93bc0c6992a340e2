"""Host loader + on-device batch preparation
(counterpart of mmhand_tpu/data/loader.py).

* a deterministic (seed, epoch)-keyed global permutation, sharded per host
  (the ``DistributedSampler.set_epoch`` equivalent, reference train.py:52-53);
* a small thread pool prefetches raw uint8/uint16 records (PIL decode is the
  only host work);
* ``make_prepare_batch`` copies a raw batch to the device and renders there
  what the reference computed per item in Python workers: normalization,
  21-channel Gaussian heatmaps (sigma 6) and depth planes (reference
  data/generic_dataset.py:133-180).  The heatmaps go through
  ``ops.heatmap.gaussian_heatmaps``, the port's kernel K1 on a CUDA device.
"""

from __future__ import annotations

import itertools
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch

from mmhand_torch.ops.depth import GAN_DEPTH_SCALE, depth_to_rgb_planes
from mmhand_torch.ops.heatmap import gaussian_heatmaps
from mmhand_torch.ops.image import normalize_image

PRERENDERED_KEYS = ("H1", "P1", "D1", "H2", "P2", "D2")


def epoch_permutation(n: int, seed: int, epoch: int) -> np.ndarray:
    """Global permutation keyed by (seed, epoch)."""
    return np.random.default_rng([seed, epoch]).permutation(n)


def host_shard(indices: np.ndarray, host_id: int, num_hosts: int) -> np.ndarray:
    """Contiguous per-host shard of the permuted index sequence (drops the
    ragged tail so every host sees the same count — the reference's
    DistributedSampler pads instead; divergence noted)."""
    per = len(indices) // num_hosts
    return indices[host_id * per:(host_id + 1) * per]


def make_prepare_batch(sigma: float = 6.0, device="cuda"):
    """Raw host arrays -> generator batch on ``device``.

    Returns a function of a raw batch dict that gives {H1, P1, D1, H2, P2, D2}
    as NHWC float32 tensors.  Prerendered batches (H1..D2 already float32)
    pass through unchanged, apart from the copy to the device."""
    device = torch.device(device)

    def to_device(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(device)

    def render(img_u8, depth_u16, uv):
        h = img_u8.shape[1]
        img = normalize_image(img_u8)
        heat = gaussian_heatmaps(uv, h, h, sigma)
        depth = depth_u16.to(torch.float32) / GAN_DEPTH_SCALE
        return img, heat, depth_to_rgb_planes(depth)

    def prepare(raw: dict) -> dict:
        if "H1" in raw:
            return {k: to_device(v) for k, v in raw.items()}
        h1, p1, d1 = render(to_device(raw["src_image"]),
                            to_device(raw["src_depth"]),
                            to_device(raw["src_uv"]))
        h2, p2, d2 = render(to_device(raw["tgt_image"]),
                            to_device(raw["tgt_depth"]),
                            to_device(raw["tgt_uv"]))
        return {"H1": h1, "P1": p1, "D1": d1, "H2": h2, "P2": p2, "D2": d2}

    return prepare


class HostLoader:
    """Iterates epochs of raw numpy batches with background prefetch."""

    def __init__(self, dataset, batch_size: int, *, seed: int = 49,
                 host_id: int = 0, num_hosts: int = 1,
                 shuffle: bool = True, num_threads: int = 4,
                 prefetch: int = 2, drop_last: bool = True,
                 max_items: Optional[int] = None, cache: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        # optional RAM cache of decoded raw items (pairing is fixed at
        # dataset construction, so index-keyed caching is sound)
        self._cache: Optional[dict] = {} if cache else None
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.shuffle = shuffle
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.max_items = max_items

    def steps_per_epoch(self) -> int:
        n = len(self.dataset)
        if self.max_items:
            n = min(n, self.max_items)
        n = n // self.num_hosts
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _load_pair(self, i: int):
        if self._cache is None:
            return self.dataset.load_pair(i)
        if i not in self._cache:
            self._cache[i] = self.dataset.load_pair(i)
        return self._cache[i]

    def _assemble(self, idxs) -> dict:
        if getattr(self.dataset, "prerendered", False):
            # items are full rendered dicts
            items = [self.dataset[int(i)] for i in idxs]
            out = {k: np.stack([it[k] for it in items])
                   for k in PRERENDERED_KEYS}
            out["src_paths"] = [it["H1_path"] for it in items]
            out["tgt_paths"] = [it["H2_path"] for it in items]
            return out
        srcs, tgts = zip(*(self._load_pair(int(i)) for i in idxs))
        return {
            "src_image": np.stack([s.image for s in srcs]),
            "src_depth": np.stack([s.depth for s in srcs]),
            "src_uv": np.stack([s.uv for s in srcs]),
            "src_z": np.stack([s.z for s in srcs]),
            "tgt_image": np.stack([t.image for t in tgts]),
            "tgt_depth": np.stack([t.depth for t in tgts]),
            "tgt_uv": np.stack([t.uv for t in tgts]),
            "tgt_z": np.stack([t.z for t in tgts]),
            "src_paths": [s.path for s in srcs],
            "tgt_paths": [t.path for t in tgts],
        }

    def epoch(self, epoch: int) -> Iterator[dict]:
        n = len(self.dataset)
        if self.max_items:
            n = min(n, self.max_items)
        order = (epoch_permutation(n, self.seed, epoch) if self.shuffle
                 else np.arange(n))
        order = host_shard(order, self.host_id, self.num_hosts)
        if hasattr(self.dataset, "set_epoch"):  # per-index draws of the epoch
            self.dataset.set_epoch(epoch)
        nb = self.steps_per_epoch()
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]

        # N decode workers pipeline whole batches (PIL releases the GIL
        # during decode); results are yielded strictly in order.
        with ThreadPoolExecutor(max_workers=self.num_threads) as ex:
            window = self.prefetch + self.num_threads
            it = iter(batches)
            inflight: deque = deque(
                ex.submit(self._assemble, b)
                for b in itertools.islice(it, window))
            while inflight:
                item = inflight.popleft().result()
                nxt = next(it, None)
                if nxt is not None:
                    inflight.append(ex.submit(self._assemble, nxt))
                yield item
