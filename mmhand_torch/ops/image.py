"""Image value-range transforms, and the crop geometry of the preprocessing
(counterpart of mmhand_tpu/ops/image.py).

The crop helpers are numpy: they run on the host, once per frame, in
``data.preprocess``."""

from __future__ import annotations

import numpy as np
import torch

BBOX_MARGIN = 20  # pixels (reference tool/create_RHD_DB.py:42-47)


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """[0, 255] -> [-1, 1] float32 (reference data/generic_dataset.py:182-185)."""
    return (img.to(torch.float32) / 255.0 - 0.5) / 0.5


def denormalize_image(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 255] uint8: clip, then truncate (reference
    util/util.py:15-24 tensor2im, reference aug.py:61-66)."""
    img = (img.to(torch.float32) + 1.0) / 2.0 * 255.0
    return img.clamp(0, 255).to(torch.uint8)


def bbox_from_uv(uv, shape_hw, margin: int = BBOX_MARGIN):
    """The keypoints' extent, widened by ``margin`` and clipped to the frame,
    as (xmin, xmax, ymin, ymax) ints.  The coordinates are truncated to
    ints before the min and max (reference tool/create_RHD_DB.py:35-49
    get_bbox).  ``uv`` is (K, 2) (x, y); ``shape_hw`` the frame's (height,
    width)."""
    uv = np.asarray(uv)
    xs = uv[:, 0].astype(np.int64)
    ys = uv[:, 1].astype(np.int64)
    xmin = max(0, int(xs.min()) - margin)
    ymin = max(0, int(ys.min()) - margin)
    xmax = min(int(shape_hw[1]), int(xs.max()) + margin)
    ymax = min(int(shape_hw[0]), int(ys.max()) + margin)
    return xmin, xmax, ymin, ymax


def rescale_intrinsics(k, xmin, ymin, xmax, ymax, size: int):
    """The camera matrix of the crop resized to ``size``: K' = S T K, T the
    crop's shift and S the resize (reference tool/create_RHD_DB.py:248-264,
    which writes 256. for ``size``; its only call uses 256)."""
    k = np.asarray(k, np.float64)
    shift = np.array([[1.0, 0.0, -xmin], [0.0, 1.0, -ymin], [0.0, 0.0, 1.0]])
    xscale = float(size) / (xmax - xmin + 1.0)
    yscale = float(size) / (ymax - ymin + 1.0)
    scale = np.diag([xscale, yscale, 1.0])
    return scale @ shift @ k


def rescale_uv(uv, xmin, ymin, xmax, ymax, size: int):
    """Keypoints in the frame of the crop resized to ``size``
    (reference tool/create_RHD_DB.py:248-250)."""
    uv = np.asarray(uv, np.float64).copy()
    uv[:, 0] = (uv[:, 0] - xmin) / (xmax - xmin + 1.0) * size
    uv[:, 1] = (uv[:, 1] - ymin) / (ymax - ymin + 1.0) * size
    return uv


def flip_uv_x(uv, size: int):
    """x mirrored in a flipped (right-hand) crop, x' = x + 2 (size/2 - x),
    in ``uv``'s float type (reference tool/create_RHD_DB.py:292-294).
    ``data.preprocess`` passes float64, as mmhand_tpu's preprocessing
    computes it, so the annotations stay byte-equal to mmhand_tpu's; on
    float32 this equals mmhand_tpu's ``flip_uv_x``, which computes in
    float32."""
    uv = np.asarray(uv)
    uv = uv.astype(np.result_type(uv.dtype, np.float32), copy=False)
    f = uv.dtype.type
    x = uv[..., 0] + f(2.0) * (f(size / 2.0) - uv[..., 0])
    return np.stack([x, uv[..., 1]], axis=-1)
