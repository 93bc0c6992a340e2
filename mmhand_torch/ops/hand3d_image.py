"""Image-space helpers of the hand3d (ColorHandPose3D) stack (counterpart
of mmhand_tpu/ops/hand3d_image.py; reference
hand_pose_estimators/CVPR2020_hand3d/utils/general.py and
data/BinaryDbReader.py), batched tensor code on any device.  Images and
scoremaps are NHWC.

* ``resize_bilinear_tf1``: TF1's ``tf.image.resize_images`` default, the
  source of output pixel i at i * in / out (no half-pixel centres, so not
  ``F.interpolate(align_corners=False)``), clamped at the last pixel, so
  the last in / out - 1 outputs of an upsampled axis repeat its last
  pixel.
* ``crop_and_resize``: ``tf.image.crop_and_resize`` with one box per image:
  corners normalised over (size - 1), align-corners sampling inside the
  box, and each of the four neighbours outside the image read as 0 on its
  own (TF's extrapolation value).
* ``single_obj_scoremap``: the blob that holds the maximum, grown from it by
  ``max(H, W) // 10`` rounds of a 21x21 dilation ANDed with the rounded
  foreground (the reference's per-sample loop, batched).  The dilation is a
  max pool with -inf padding, taken as a 21x1 pool then a 1x21 pool: the
  same maximum, 42 comparisons per pixel in place of 441.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_tf1(x: torch.Tensor, out_hw) -> torch.Tensor:
    """TF1-default bilinear resize of NHWC ``x`` to ``out_hw``
    (reference nets/ColorHandPose3DNetwork.py:100,177,218)."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x

    def axis_weights(in_size, out_size):
        src = torch.arange(out_size, dtype=torch.float32,
                           device=x.device) * (in_size / out_size)
        i0 = torch.floor(src).long().clamp(0, in_size - 1)
        i1 = (i0 + 1).clamp(0, in_size - 1)
        return i0, i1, src - i0.float()

    y0, y1, fy = axis_weights(h, oh)
    x0, x1, fx = axis_weights(w, ow)
    # a lerp is exact where both neighbours are the clamped last pixel, so
    # the plateau there ties exactly and an argmax takes its first pixel,
    # as mmhand_tpu's fused multiply-add gives
    rows = torch.lerp(x[:, y0], x[:, y1],
                      fy[None, :, None, None].to(x.dtype))   # (B, oh, W, C)
    return torch.lerp(rows[:, :, x0], rows[:, :, x1],
                      fx[None, None, :, None].to(x.dtype))


def crop_and_resize(image: torch.Tensor, boxes: torch.Tensor,
                    crop_size: int) -> torch.Tensor:
    """(B, H, W, C) image, (B, 4) boxes [y1, x1, y2, x2] normalised over
    (H - 1, W - 1) -> (B, crop_size, crop_size, C) float32."""
    b, h, w, _ = image.shape
    image = image.float()
    t = torch.arange(crop_size, dtype=torch.float32,
                     device=image.device) / max(crop_size - 1, 1)

    def axis_coords(lo, hi, in_size):
        return (lo[:, None] + (hi - lo)[:, None] * t[None, :]) * (in_size - 1)

    ys = axis_coords(boxes[:, 0], boxes[:, 2], h)            # (B, S)
    xs = axis_coords(boxes[:, 1], boxes[:, 3], w)
    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    fy = (ys - y0)[:, :, None, None]
    fx = (xs - x0)[:, None, :, None]
    rows = torch.arange(b, device=image.device)[:, None]

    def val(yi, xi):
        ok = (((yi >= 0) & (yi <= h - 1))[:, :, None, None]
              & ((xi >= 0) & (xi <= w - 1))[:, None, :, None])
        v = image[rows, yi.clamp(0, h - 1)]                   # (B, S, W, C)
        v = v[rows[:, :, None], torch.arange(
            v.shape[1], device=image.device)[None, :, None],
            xi.clamp(0, w - 1)[:, None, :]]                   # (B, S, S, C)
        return v * ok

    top = val(y0, x0) * (1 - fx) + val(y0, x0 + 1) * fx
    bot = val(y0 + 1, x0) * (1 - fx) + val(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def crop_image_from_xy(image: torch.Tensor, crop_location: torch.Tensor,
                       crop_size: int, scale) -> torch.Tensor:
    """Scaled crop of ``crop_size`` around (y, x) per sample (reference
    utils/general.py:163-197); scale (B,) or a scalar."""
    b, h, w, _ = image.shape
    scale = torch.as_tensor(scale, dtype=torch.float32,
                            device=image.device).reshape(-1).expand(b)
    loc = crop_location.float().reshape(b, 2)
    size_scaled = crop_size / scale
    half = torch.div(size_scaled, 2, rounding_mode="floor")
    y1 = loc[:, 0] - half
    x1 = loc[:, 1] - half
    boxes = torch.stack([y1 / h, x1 / w, (y1 + size_scaled) / h,
                         (x1 + size_scaled) / w], -1)
    return crop_and_resize(image, boxes, crop_size)


def find_max_location(scoremap: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, 2) int32 [y, x] of the first maximum (reference
    utils/general.py:199-230)."""
    b, _, w = scoremap.shape
    idx = torch.argmax(scoremap.reshape(b, -1), dim=1)
    return torch.stack([torch.div(idx, w, rounding_mode="floor"), idx % w],
                       -1).int()


def single_obj_scoremap(scoremap: torch.Tensor,
                        filter_size: int = 21) -> torch.Tensor:
    """(B, H, W, C) segmentation logits -> (B, H, W, 1) float mask of the
    foreground blob that holds the maximum (reference utils/general.py:
    233-268)."""
    b, h, w, _ = scoremap.shape
    fg = torch.amax(torch.softmax(scoremap, dim=-1)[..., 1:], dim=-1)
    det_fg = torch.round(fg)
    loc = find_max_location(fg).long()
    obj = torch.zeros((b, 1, h, w), dtype=torch.float32,
                      device=scoremap.device)
    obj[torch.arange(b, device=obj.device), 0, loc[:, 0], loc[:, 1]] = 1.0
    det_fg = det_fg[:, None]
    r = filter_size // 2
    # the reference's dilation2d adds its constant 1/k^2 kernel inside the
    # max, which is max(obj) + 1/k^2
    for _ in range(max(h, w) // r):
        dil = F.max_pool2d(obj, (filter_size, 1), 1, (r, 0))
        dil = F.max_pool2d(dil, (1, filter_size), 1, (0, r))
        obj = torch.round(det_fg * (dil + 1.0 / filter_size ** 2))
    return obj.permute(0, 2, 3, 1)


def calc_center_bb(mask: torch.Tensor):
    """Centre and extent of a binary mask's box (reference
    utils/general.py:271-328).

    (B, H, W) or (B, H, W, 1) -> (centre (B, 2) [y, x], box (B, 2, 2),
    crop size (B, 1)); an empty mask gives the reference's constants,
    centre (160, 160) and size 100."""
    if mask.dim() == 4:
        mask = mask[..., 0]
    _, h, w = mask.shape
    on = mask > 0.5
    ys = torch.arange(h, dtype=torch.float32, device=mask.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=mask.device)[None, None, :]
    big = 1e9
    y_min = torch.where(on, ys, big).amin(dim=(1, 2))
    y_max = torch.where(on, ys, -big).amax(dim=(1, 2))
    x_min = torch.where(on, xs, big).amin(dim=(1, 2))
    x_max = torch.where(on, xs, -big).amax(dim=(1, 2))
    empty = ~on.any(dim=2).any(dim=1)
    center = torch.stack([0.5 * (y_max + y_min), 0.5 * (x_max + x_min)], -1)
    center = torch.where(empty[:, None], 160.0, center)
    crop_size = torch.maximum(y_max - y_min, x_max - x_min)[:, None]
    crop_size = torch.where(empty[:, None], 100.0, crop_size)
    bb = torch.stack([torch.stack([y_min, x_min], -1),
                      torch.stack([y_max, x_max], -1)], -1)
    return center, bb, crop_size


def detect_keypoints(scoremaps: torch.Tensor) -> torch.Tensor:
    """(B, H, W, K) -> (B, K, 2) float [y, x] of each channel's first
    maximum (reference utils/general.py:331-345)."""
    b, h, w, k = scoremaps.shape
    idx = torch.argmax(scoremaps.reshape(b, h * w, k), dim=1)
    return torch.stack([torch.div(idx, w, rounding_mode="floor"), idx % w],
                       -1).float()


def gaussian_scoremap(coords_hw: torch.Tensor, out_hw, sigma: float,
                      valid=None) -> torch.Tensor:
    """hand3d's keypoint maps (reference data/BinaryDbReader.py:413-459):
    coordinates truncated to integers, exp(-d^2 / sigma^2) (no factor 2),
    zero for a keypoint that is invisible or not strictly inside
    (0, size - 1).

    coords_hw: (..., K, 2) [y, x]; valid: (..., K) or None ->
    (..., H, W, K)."""
    h, w = out_hw
    coords = torch.floor(coords_hw).int().float()
    cond = ((coords[..., 0] < h - 1) & (coords[..., 0] > 0)
            & (coords[..., 1] < w - 1) & (coords[..., 1] > 0))
    if valid is not None:
        cond = cond & (torch.as_tensor(valid, device=coords.device).float()
                       > 0.5)
    ys = torch.arange(h, dtype=torch.float32,
                      device=coords.device)[:, None, None]
    xs = torch.arange(w, dtype=torch.float32,
                      device=coords.device)[None, :, None]
    cy = coords[..., None, None, :, 0]
    cx = coords[..., None, None, :, 1]
    dist = (ys - cy) ** 2 + (xs - cx) ** 2
    return torch.exp(-dist / sigma ** 2) * cond[..., None, None, :].float()
