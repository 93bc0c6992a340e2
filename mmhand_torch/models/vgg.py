"""VGG19 feature extractor for the perceptual loss (counterpart of
mmhand_tpu/models/vgg.py).

The reference truncates torchvision's pretrained ``vgg19().features`` at layer
index ``--perceptual_layers`` (default 3 = relu1_2; reference
losses/L1_plus_perceptualLoss.py:22-30).  ``VGG19Features`` rebuilds those
layers as an ``nn.Sequential`` whose indices are torchvision's, so its
``state_dict`` keys are ``features.<i>`` without the prefix.

Pretrained weights: no torchvision here, so ImageNet weights come as an
``.npz`` made by tools/convert_torch_weights.py and loaded with
``load_vgg19_npz``.  Without them the trainer draws random weights and warns
(mmhand_tpu/train/loop.py:53-65).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

# torchvision VGG19 'E' config: conv widths with 'M' maxpools between stages
_VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]

# ImageNet renorm constants (reference L1_plus_perceptualLoss.py:40-52)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def torch_layer_sequence():
    """(torch_index, kind, width) sequence mirroring vgg19().features."""
    seq = []
    idx = 0
    for v in _VGG19_CFG:
        if v == "M":
            seq.append((idx, "pool", 0))
            idx += 1
        else:
            seq.append((idx, "conv", v))
            seq.append((idx + 1, "relu", 0))
            idx += 2
    return seq


class VGG19Features(nn.Sequential):
    """VGG19 features truncated at torch layer index ``truncate_at``
    (inclusive, as the reference's ``if i == perceptual_layers: break`` after
    adding layer i).  NHWC float in, NHWC float32 features out; with
    ``compute_dtype`` bf16 or fp16 it runs under ``torch.autocast``."""

    def __init__(self, truncate_at: int = 3,
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16):
        layers: list[nn.Module] = []
        width = 3
        for idx, kind, out in torch_layer_sequence():
            if kind == "conv":
                layers.append(nn.Conv2d(width, out, 3, padding=1))
                width = out
            elif kind == "relu":
                layers.append(nn.ReLU())
            else:
                layers.append(nn.MaxPool2d(2, 2))
            if idx == truncate_at:
                break
        super().__init__(*layers)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        dtype = self.compute_dtype
        with torch.autocast(x.device.type, dtype=dtype,
                            enabled=dtype is not None):
            x = super().forward(x)
        return x.permute(0, 2, 3, 1).float()


@functools.lru_cache(maxsize=None)
def _renorm_constants(device: torch.device):
    # made once per device: a host->device copy of a pageable array would
    # wait for the stream at every call
    return (torch.from_numpy(IMAGENET_MEAN).to(device),
            torch.from_numpy(IMAGENET_STD).to(device))


def imagenet_renorm(img_m11: torch.Tensor) -> torch.Tensor:
    """NHWC [-1, 1] image -> ImageNet-normalized
    (reference L1_plus_perceptualLoss.py:54-58)."""
    mean, std = _renorm_constants(img_m11.device)
    x = (img_m11 + 1.0) / 2.0
    return (x - mean) / std


def load_vgg19_npz(path: str, truncate_at: int = 3) -> dict[str, torch.Tensor]:
    """Converted torchvision weights (tools/convert_torch_weights.py: keys
    ``features.<i>.weight`` OIHW and ``features.<i>.bias``) -> the state_dict
    of ``VGG19Features(truncate_at)``."""
    sd = {}
    with np.load(path) as raw:
        for idx, kind, _ in torch_layer_sequence():
            if idx > truncate_at:
                break
            if kind == "conv":
                for leaf in ("weight", "bias"):
                    sd[f"{idx}.{leaf}"] = torch.from_numpy(
                        np.array(raw[f"features.{idx}.{leaf}"], np.float32))
    return sd
