"""GAN-path depth decoding (counterpart of mmhand_tpu/ops/depth.py).

The crops store depth as an RGB PNG with the value packed into two 8-bit
channels; the GAN data path decodes ``256*G + R`` and scales it by 1/700
(reference data/generic_dataset.py:148-159).  Inputs are RGB-ordered.
"""

from __future__ import annotations

import torch

GAN_DEPTH_SCALE = 700.0  # reference generic_dataset.py:156


def decode_depth_gan(rgb: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) RGB -> (..., H, W) float32 depth, (256*G + R) / 700."""
    rgb = rgb.to(torch.float32)
    return (256.0 * rgb[..., 1] + rgb[..., 0]) / GAN_DEPTH_SCALE


def depth_to_rgb_planes(depth: torch.Tensor) -> torch.Tensor:
    """(..., H, W) decoded depth -> (..., H, W, 3) float32, normalized to
    [-1, 1] and replicated to 3 channels (reference generic_dataset.py:155-159)."""
    d = (depth.to(torch.float32) - 0.5) / 0.5
    return torch.stack([d, d, d], dim=-1)
