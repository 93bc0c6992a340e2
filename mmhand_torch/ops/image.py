"""Image value-range transforms (counterpart of mmhand_tpu/ops/image.py)."""

from __future__ import annotations

import torch


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """[0, 255] -> [-1, 1] float32 (reference data/generic_dataset.py:182-185)."""
    return (img.to(torch.float32) / 255.0 - 0.5) / 0.5


def denormalize_image(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 255] uint8: clip, then truncate (reference
    util/util.py:15-24 tensor2im, reference aug.py:61-66)."""
    img = (img.to(torch.float32) + 1.0) / 2.0 * 255.0
    return img.clamp(0, 255).to(torch.uint8)
