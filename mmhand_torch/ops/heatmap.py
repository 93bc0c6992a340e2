"""Gaussian keypoint heatmaps (counterpart of mmhand_tpu/ops/heatmap.py).

Reference semantics (reference data/generic_dataset.py:208-217,238-242):

    map[i, j] = exp(-((j - x)^2 + (i - y)^2) / (2 sigma^2))
    map[map > 1] = 1          (no-op for a true Gaussian, kept anyway)
    map[map < 0.0099] = 0     (sparsity clip)

Layout is NHWC: heatmaps come back as (..., H, W, K).

``gaussian_heatmaps`` dispatches on where ``uv`` lies: a CPU tensor goes to
the plain version ``gaussian_heatmaps_ref``, a CUDA tensor to the hand-written
kernel in ``csrc/heatmap.cu``, built at first use by ``ops._build``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

# Sparsity clip threshold (reference generic_dataset.py:215).
CLIP_LO = 0.0099


def gaussian_heatmaps_ref(uv: torch.Tensor, height: int = 256,
                          width: int = 256, sigma: float = 6.0) -> torch.Tensor:
    """Plain PyTorch heatmaps: (..., K, 2) (x, y) -> (..., H, W, K) float32."""
    uv = uv.to(torch.float32)
    x = uv[..., 0][..., None, None, :]                    # (..., 1, 1, K)
    y = uv[..., 1][..., None, None, :]
    rows = torch.arange(height, dtype=torch.float32, device=uv.device)
    cols = torch.arange(width, dtype=torch.float32, device=uv.device)
    d2 = (cols[:, None] - x) ** 2 + (rows[:, None, None] - y) ** 2
    m = torch.exp(-d2 / (2.0 * sigma * sigma))
    m = torch.clamp(m, max=1.0)
    return torch.where(m < CLIP_LO, torch.zeros_like(m), m)


@functools.lru_cache(maxsize=None)
def _kernel():
    from mmhand_torch.ops._build import load_library

    fn = load_library().mmhand_gaussian_heatmaps
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _gaussian_heatmaps_cuda(uv: torch.Tensor, height: int, width: int,
                            sigma: float) -> torch.Tensor:
    if uv.dtype != torch.float32:
        raise TypeError(f"gaussian_heatmaps: uv must be float32, got {uv.dtype}")
    if uv.dim() < 2 or uv.shape[-1] != 2:
        raise ValueError(f"gaussian_heatmaps: uv must be (..., K, 2), got "
                         f"{tuple(uv.shape)}")
    if not uv.is_contiguous():
        raise ValueError("gaussian_heatmaps: uv must be contiguous")
    lead, k = tuple(uv.shape[:-2]), uv.shape[-2]
    batch = math.prod(lead)
    if batch * height >= 2 ** 31 or width * k >= 2 ** 31:
        raise ValueError("gaussian_heatmaps: batch * height and width * K "
                         "must stay below 2^31")
    out = torch.empty(lead + (height, width, k), dtype=torch.float32,
                      device=uv.device)
    with torch.cuda.device(uv.device):
        stream = torch.cuda.current_stream(uv.device).cuda_stream
        err = _kernel()(uv.data_ptr(), out.data_ptr(), batch, height, width,
                        k, float(sigma), stream)
    if err != 0:
        raise RuntimeError(f"gaussian_heatmaps kernel launch failed: "
                           f"cudaError {err}")
    gaussian_heatmaps.launches += 1
    return out


def gaussian_heatmaps(uv: torch.Tensor, height: int = 256, width: int = 256,
                      sigma: float = 6.0) -> torch.Tensor:
    """Batched heatmaps from keypoints.

    Args:
      uv: (..., K, 2) float32 (x, y) pixel coordinates.
    Returns:
      (..., H, W, K) float32 heatmaps on uv's device.  On a CUDA device this
      is the hand-written kernel, and ``gaussian_heatmaps.launches`` counts
      its launches.
    """
    if uv.device.type == "cpu":
        return gaussian_heatmaps_ref(uv, height, width, sigma)
    if uv.device.type == "cuda":
        return _gaussian_heatmaps_cuda(uv, height, width, sigma)
    raise ValueError(f"gaussian_heatmaps: no kernel for device {uv.device}")


gaussian_heatmaps.launches = 0
