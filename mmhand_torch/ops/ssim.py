"""SSIM (counterpart of mmhand_tpu/ops/ssim.py), matching the reference's
vendored pytorch_ssim (reference baselines/quantitative_on_benchmarks/
pytorch_ssim/__init__.py:7-73): 11x11 Gaussian window (sigma 1.5), a
per-channel depthwise convolution with zero padding 5, C1 = 0.01^2,
C2 = 0.03^2, mean over all pixels.  Images are NHWC, as everywhere in the
port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

WINDOW_SIZE = 11
WINDOW_SIGMA = 1.5
C1 = 0.01 ** 2
C2 = 0.03 ** 2


def gaussian_window(size: int = WINDOW_SIZE, sigma: float = WINDOW_SIGMA,
                    device=None) -> torch.Tensor:
    """(size, size) float32 window summing to 1."""
    x = torch.arange(size, dtype=torch.float32, device=device)
    g = torch.exp(-((x - size // 2) ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    w2d = torch.outer(g, g)
    return w2d / w2d.sum()


def _blur(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Depthwise zero-padded conv of an NCHW image with a (k, k) window."""
    c, k = img.shape[1], window.shape[0]
    return F.conv2d(img, window.expand(c, 1, k, k), padding=k // 2, groups=c)


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         size_average: bool = True) -> torch.Tensor:
    """SSIM of two NHWC float images (same value range, e.g. [0, 1]).

    Returns a scalar if ``size_average`` else one mean per image, float32.
    """
    img1 = img1.to(torch.float32).permute(0, 3, 1, 2)
    img2 = img2.to(torch.float32).permute(0, 3, 1, 2)
    window = gaussian_window(device=img1.device)

    mu1 = _blur(img1, window)
    mu2 = _blur(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _blur(img1 * img1, window) - mu1_sq
    sigma2_sq = _blur(img2 * img2, window) - mu2_sq
    sigma12 = _blur(img1 * img2, window) - mu1_mu2

    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))
