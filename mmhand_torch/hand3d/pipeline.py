"""hand3d training samples from raw records (counterpart of
mmhand_tpu/hand3d/pipeline.py; reference
hand_pose_estimators/CVPR2020_hand3d/data/BinaryDbReader.py:130-380).

``derive_batch`` turns a batch of raw records into the training dict in
one batched pass on the device: image (mean-subtracted), hand_side
(one-hot 2), keypoint_vis21, keypoint_uv21, keypoint_xyz21, keypoint_scale,
keypoint_xyz21_normed, keypoint_xyz21_local, keypoint_xyz21_can, rot_mat,
scoremap, hand_mask (2 channels), and with hand_crop also image_crop,
crop_scale and cam_mat.

Kept from the reference: the palm replaces the wrist as mean(wrist, kp12)
when use_wrist_coord is off (:141-144); scale = |kp12 - kp11| of the
root-relative coordinates (:238-242); rot_mat is stored inverted
(:250-253); the scoremaps are exp(-d^2 / sigma^2) (no factor 2) over
truncated coordinates (:413-459); the crop size is clamped to [50, 500] px,
then its scale to [1, 10] (:295-308).

The noise comes from the ``torch.Generator`` the caller passes: a normal
truncated at 2 standard deviations, a uniform 1.0-1.2 crop scale and a
Bernoulli channel dropout of the scoremaps; the draws cannot be
mmhand_tpu's.

Repaired: the hand side comes from the parts mask, the side with more hand
pixels (:215-233).  A mask with no hand pixel on either side, as the
packed GAN DB writes (a mask of ones), made mmhand_tpu take the right
hand's rows, which that DB fills with zero padding, so every keypoint was
invisible and posenet's loss 0.  Here such a record takes the side with
more visible keypoints, the left on a tie; wherever the mask has hand
pixels the rule is mmhand_tpu's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mmhand_torch.ops import hand3d_image as h3img
from mmhand_torch.ops.hand_trafo import (
    bone_rel_trafo,
    canonical_trafo,
    flip_right_hand,
)
from mmhand_torch.utils import trace

RECORD_KEYS = ("keypoint_xyz", "keypoint_uv", "cam_mat", "image",
               "hand_parts", "keypoint_vis")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The BinaryDbReader flags (reference :32-92)."""

    image_size: tuple = (256, 256)
    crop_size: int = 256
    sigma: float = 25.0
    use_wrist_coord: bool = True
    hand_crop: bool = False
    coord_uv_noise: bool = False
    coord_uv_noise_sigma: float = 2.5
    crop_center_noise: bool = False
    crop_center_noise_sigma: float = 20.0
    crop_scale_noise: bool = False
    crop_offset_noise: bool = False
    crop_offset_noise_sigma: float = 10.0
    scoremap_dropout: bool = False
    scoremap_dropout_prob: float = 0.8


def trunc_normal(shape, stddev: float, generator: torch.Generator,
                 device) -> torch.Tensor:
    """``stddev`` times a standard normal truncated to [-2, 2], by the
    inverse CDF of a uniform draw (jax.random.truncated_normal's law)."""
    edge = math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(shape, generator=generator, device=generator.device)
    z = torch.erfinv(u * (2 * edge) - edge) * math.sqrt(2.0)
    return (stddev * z.clamp(-2.0, 2.0)).to(device)


def _uniform(shape, lo: float, hi: float, generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (lo + (hi - lo) * u).to(device)


def _as_tensors(records: dict, device) -> dict:
    out = {}
    for k in RECORD_KEYS:
        v = records[k]
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = v.to(device)
    return out


def _palmify(arr: torch.Tensor) -> torch.Tensor:
    """(B, 42, ...) -> the wrists replaced by the palms (reference
    :141-157)."""
    palm_l = 0.5 * (arr[:, 0] + arr[:, 12])
    palm_r = 0.5 * (arr[:, 21] + arr[:, 33])
    return torch.cat([palm_l[:, None], arr[:, 1:21], palm_r[:, None],
                      arr[:, -20:]], 1)


def derive_batch(records: dict, cfg: PipelineConfig,
                 generator: torch.Generator, device="cuda") -> dict:
    """Raw records -> the training dict, on ``device``.

    records: keypoint_xyz (B, 42, 3), keypoint_uv (B, 42, 2), cam_mat
    (B, 3, 3), image (B, H, W, 3) uint8, hand_parts (B, H, W) integer,
    keypoint_vis (B, 42) bool; numpy arrays or tensors.  ``generator``
    draws the noise that ``cfg`` turns on.  The whole derivation is the
    device span ``hand3d.derive`` (``utils.trace``)."""
    device = torch.device(device)
    with trace.span("hand3d.derive", device):
        return _derive(records, cfg, generator, device)


def _derive(records: dict, cfg: PipelineConfig, generator: torch.Generator,
            device: torch.device) -> dict:
    r = _as_tensors(records, device)
    b = r["image"].shape[0]
    h, w = cfg.image_size

    keypoint_xyz = r["keypoint_xyz"].float()
    keypoint_uv = r["keypoint_uv"].float()
    keypoint_vis = r["keypoint_vis"].bool()
    hand_parts = r["hand_parts"].long()
    cam_mat = r["cam_mat"].float()

    if not cfg.use_wrist_coord:
        keypoint_xyz = _palmify(keypoint_xyz)
        keypoint_uv = _palmify(keypoint_uv)
        vis_l = keypoint_vis[:, 0] | keypoint_vis[:, 12]
        vis_r = keypoint_vis[:, 21] | keypoint_vis[:, 33]
        keypoint_vis = torch.cat([vis_l[:, None], keypoint_vis[:, 1:21],
                                  vis_r[:, None], keypoint_vis[:, -20:]], 1)

    if cfg.coord_uv_noise:
        keypoint_uv = keypoint_uv + trunc_normal(
            (b, 42, 2), cfg.coord_uv_noise_sigma, generator, device)

    image = r["image"].float() / 255.0 - 0.5
    fg = hand_parts > 1
    hand_mask = torch.stack([~fg, fg], 3).int()

    # the dominant hand from the parts mask (reference :215-233)
    num_l = ((hand_parts > 1) & (hand_parts < 18)).sum(dim=(1, 2))
    num_r = (hand_parts > 17).sum(dim=(1, 2))
    no_hand = (num_l == 0) & (num_r == 0)
    more_visible_l = (keypoint_vis[:, :21].sum(1)
                      >= keypoint_vis[:, -21:].sum(1))
    left = torch.where(no_hand, more_visible_l, num_l > num_r)
    hand_side = torch.stack([left, ~left], 1).float()

    sel = left[:, None, None]
    kp_xyz21 = torch.where(sel, keypoint_xyz[:, :21], keypoint_xyz[:, -21:])
    kp_uv21 = torch.where(sel, keypoint_uv[:, :21], keypoint_uv[:, -21:])
    kp_vis21 = torch.where(left[:, None], keypoint_vis[:, :21],
                           keypoint_vis[:, -21:])

    kp_rel = kp_xyz21 - kp_xyz21[:, :1]
    scale = torch.sqrt(torch.sum((kp_rel[:, 12] - kp_rel[:, 11]) ** 2, -1))
    kp_normed = kp_rel / scale[:, None, None]
    kp_local = bone_rel_trafo(kp_normed)
    kp_can, rot = canonical_trafo(kp_normed)
    kp_can = flip_right_hand(kp_can, ~left)

    out = {
        "image": image,
        "hand_mask": hand_mask,
        "hand_side": hand_side,
        "keypoint_xyz21": kp_xyz21,
        "keypoint_vis21": kp_vis21,
        "keypoint_scale": scale[:, None],
        "keypoint_xyz21_normed": kp_normed,
        "keypoint_xyz21_local": kp_local,
        "keypoint_xyz21_can": kp_can,
        "rot_mat": torch.linalg.inv(rot),
    }

    if cfg.hand_crop:
        crop_center = kp_uv21[:, 12].flip(-1)                  # [y, x]
        finite = torch.isfinite(crop_center).all(-1, keepdim=True)
        crop_center = torch.where(finite, crop_center, 0.0)
        if cfg.crop_center_noise:
            crop_center = crop_center + trunc_normal(
                (b, 2), cfg.crop_center_noise_sigma, generator, device)
        scale_noise = (_uniform((b,), 1.0, 1.2, generator, device)
                       if cfg.crop_scale_noise else 1.0)

        # the visible keypoints' extent (the reference's boolean_mask)
        kp_hw = kp_uv21.flip(-1)
        vis = kp_vis21[:, :, None]
        min_coord = torch.where(vis, kp_hw, 1e9).amin(1).clamp(min=0.0)
        max_coord = torch.minimum(
            torch.where(vis, kp_hw, -1e9).amax(1),
            torch.tensor([h, w], dtype=torch.float32, device=device))
        crop_size_best = 2 * torch.maximum(max_coord - crop_center,
                                           crop_center - min_coord)
        crop_size_best = crop_size_best.amax(-1).clamp(50.0, 500.0)
        crop_size_best = torch.where(
            ~kp_vis21.any(1) | ~torch.isfinite(crop_size_best), 200.0,
            crop_size_best)
        crop_scale = torch.clamp(cfg.crop_size / crop_size_best, 1.0, 10.0)
        crop_scale = crop_scale * scale_noise
        if cfg.crop_offset_noise:
            crop_center = crop_center + trunc_normal(
                (b, 2), cfg.crop_offset_noise_sigma, generator, device)

        img_crop = h3img.crop_image_from_xy(image, crop_center,
                                            cfg.crop_size, crop_scale)
        half = cfg.crop_size // 2
        s = crop_scale[:, None]
        u = (kp_uv21[:, :, 0] - crop_center[:, 1:2]) * s + half
        v = (kp_uv21[:, :, 1] - crop_center[:, 0:1]) * s + half
        kp_uv21 = torch.stack([u, v], 2)

        # the camera matrix of the crop (reference :327-346)
        eye = torch.eye(3, device=device).expand(b, 3, 3)
        ones = torch.ones_like(crop_scale)
        scale_matrix = eye * torch.stack([crop_scale, crop_scale, ones],
                                         1)[:, :, None]
        trans_matrix = eye.clone()
        trans_matrix[:, 0, 2] = -(crop_center[:, 1] * crop_scale - half)
        trans_matrix[:, 1, 2] = -(crop_center[:, 0] * crop_scale - half)
        out["cam_mat"] = trans_matrix @ (scale_matrix @ cam_mat)
        out["image_crop"] = img_crop
        out["crop_scale"] = crop_scale[:, None]

    out["keypoint_uv21"] = kp_uv21

    # scoremaps of the 21 uv coordinates (reference :348-377)
    size = (cfg.crop_size, cfg.crop_size) if cfg.hand_crop else (h, w)
    scoremap = h3img.gaussian_scoremap(kp_uv21.flip(-1), size, cfg.sigma,
                                       kp_vis21)
    if cfg.scoremap_dropout:
        keep = torch.rand((b, 1, 1, 21), generator=generator,
                          device=generator.device) < cfg.scoremap_dropout_prob
        # TF's dropout scales by 1 / keep_prob and the reference multiplies
        # keep_prob right back (:370-372): the channel mask alone
        scoremap = scoremap * keep.to(device)
    out["scoremap"] = scoremap
    return out
