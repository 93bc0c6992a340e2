"""The ColorHandPose3D (hand3d) networks (counterpart of
mmhand_tpu/models/hand3d.py; reference
hand_pose_estimators/CVPR2020_hand3d/nets/ColorHandPose3DNetwork.py and
nets/PosePriorNetwork.py).

* HandSegNet: VGG-like encoder and 1x1 head -> 2-class hand segmentation,
  upsampled to the input (reference ColorHandPose3DNetwork.py:183-220).
* PoseNet2D: the 2D keypoint net, a first scoremap and 2 recurrent
  refinements over cat(scoremap, encoding), at 1/8 of the input
  (reference :225-274).
* PosePrior: canonical 3D coordinates from the scoremaps and the hand side
  (reference :311-334), with the 30-d bottleneck variant (reference
  PosePriorNetwork.py:97-122).
* ViewpointNet: axis-angle viewpoint -> rotation matrix (reference
  :339-399).
* ColorHandPose3D: detection -> single-object mask -> crop -> 2D keypoints
  -> 3D (reference :64-102).
* PosePriorNetwork: the lifting study's variants direct, bottleneck, local,
  local_w_xyz_loss and proposed (reference PosePriorNetwork.py:59-95).

Module names are the TF variable scopes (``conv1_1``, ``fc_rel0``,
``HandSegNet``), each conv a ``TFConv`` holding its ``nn.Conv2d`` as
``conv``, so that ``convert.hand3d_state_dict_from_jax`` maps mmhand_tpu's
trees one to one.  Inputs and outputs are NHWC float32, as in mmhand_tpu.

What TF does and torch does not, kept here:
* "SAME" padding.  At stride 2 on an even input TF pads 0 before and 1
  after; ``TFConv`` pads by TF's formula, not ``nn.Conv2d(padding=1)``.
* The flatten before ``fc_rel0`` and ``fc_vp0`` is NHWC, so the Dense
  kernels carry over unpermuted.
* xavier-uniform weights and constant 1e-4 biases; dropout keeps 0.8 in
  PosePrior and 0.75 in ViewpointNet, in training only, drawn from the
  generator the caller passes.
PosePrior's and ViewpointNet's Linear layers need their input width, so
they take the side of the scoremap they read.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmhand_torch.ops import hand3d_image as h3img
from mmhand_torch.ops.hand_trafo import bone_rel_trafo_inv, flip_right_hand

BIAS_INIT = 1e-4  # reference NetworkOps.conv biases (utils/general.py:49-50)
LIFTING_VARIANTS = ("direct", "bottleneck", "local", "local_w_xyz_loss",
                    "proposed")


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """tf.maximum(x, 0.01 x) (reference utils/general.py:28-33): the same
    values as one leaky relu, one kernel each way in place of three."""
    return F.leaky_relu(x, 0.01)


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """TF "SAME" padding of one axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def same_size(size: int, stride: int, times: int = 1) -> int:
    """The side after ``times`` "SAME" layers of ``stride``."""
    for _ in range(times):
        size = -(-size // stride)
    return size


class TFConv(nn.Module):
    """A TF "SAME" conv (reference NetworkOps.conv)."""

    def __init__(self, in_channels: int, features: int, kernel: int,
                 stride: int = 1):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.conv = nn.Conv2d(in_channels, features, kernel, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW in and out."""
        top, bottom = same_pads(x.shape[2], self.kernel, self.stride)
        left, right = same_pads(x.shape[3], self.kernel, self.stride)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return self.conv(x)


def init_hand3d(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """The reference's init: every conv and Linear weight xavier-uniform
    (TF's xavier_initializer, flax's xavier_uniform), every bias 1e-4."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                m.bias.fill_(BIAS_INIT)
    return net


def dropout(x: torch.Tensor, keep: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """TF ops.dropout: in training each element kept with probability
    ``keep`` and scaled by 1 / keep, else x as it is."""
    if not train:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    u = torch.rand(x.shape, generator=generator, device=generator.device)
    return torch.where(u.to(x.device) < keep, x / keep, 0.0)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.float().permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _add_conv_blocks(module: nn.Module, in_channels: int, layers, widths,
                     pools) -> list:
    """Blocks of 3x3 convs named ``conv<block>_<layer>`` on ``module``;
    returns the plan ``_run_plan`` follows, "pool" after each block whose
    flag is set."""
    plan = []
    for block, (n, width, pool) in enumerate(zip(layers, widths, pools), 1):
        for layer in range(1, n + 1):
            name = f"conv{block}_{layer}"
            setattr(module, name, TFConv(in_channels, width, 3))
            plan.append(name)
            in_channels = width
        if pool:
            plan.append("pool")
    return plan


def _run_plan(module: nn.Module, plan, x):
    """Each conv with leaky relu, each pool a 2x2 VALID max pool."""
    for step in plan:
        x = (F.max_pool2d(x, 2, 2) if step == "pool"
             else leaky_relu(getattr(module, step)(x)))
    return x


class HandSegNet(nn.Module):
    """(B, H, W, 3) mean-subtracted image -> (B, H, W, 2) background/hand
    scores, upsampled by TF1's bilinear resize (reference
    ColorHandPose3DNetwork.py:183-220)."""

    def __init__(self):
        super().__init__()
        self._plan = _add_conv_blocks(self, 3, [2, 2, 4, 4],
                                      [64, 128, 256, 512],
                                      [True, True, True, False])
        self.conv5_1 = TFConv(512, 512, 3)
        self.conv5_2 = TFConv(512, 128, 3)
        self.conv6_1 = TFConv(128, 512, 1)
        self.conv6_2 = TFConv(512, 2, 1)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = _nchw(image)
        x = _run_plan(self, self._plan, x)
        x = leaky_relu(self.conv5_1(x))
        encoding = leaky_relu(self.conv5_2(x))
        scoremap = self.conv6_2(leaky_relu(self.conv6_1(encoding)))
        return h3img.resize_bilinear_tf1(_nhwc(scoremap.float()),
                                         image.shape[1:3])


class PoseNet2D(nn.Module):
    """(B, S, S, 3) crop -> the 3 keypoint scoremaps (B, S/8, S/8, 21), the
    first and 2 recurrent refinements, not upsampled (reference
    ColorHandPose3DNetwork.py:225-274)."""

    def __init__(self, num_kp: int = 21):
        super().__init__()
        self._plan = _add_conv_blocks(self, 3, [2, 2, 4, 2],
                                      [64, 128, 256, 512],
                                      [True, True, True, False])
        width = 512
        for i in range(3, 7):
            setattr(self, f"conv4_{i}", TFConv(width, 256, 3))
            width = 256
        self.conv4_7 = TFConv(256, 128, 3)
        self.conv5_1 = TFConv(128, 512, 1)
        self.conv5_2 = TFConv(512, num_kp, 1)
        for pass_id in (6, 7):
            width = num_kp + 128
            for rec in range(1, 6):
                setattr(self, f"conv{pass_id}_{rec}", TFConv(width, 128, 7))
                width = 128
            setattr(self, f"conv{pass_id}_6", TFConv(128, 128, 1))
            setattr(self, f"conv{pass_id}_7", TFConv(128, num_kp, 1))

    def forward(self, image_crop: torch.Tensor) -> list[torch.Tensor]:
        x = _run_plan(self, self._plan, _nchw(image_crop))
        for i in range(3, 7):
            x = leaky_relu(getattr(self, f"conv4_{i}")(x))
        encoding = leaky_relu(self.conv4_7(x))
        scoremaps = [self.conv5_2(leaky_relu(self.conv5_1(encoding)))]
        for pass_id in (6, 7):
            x = torch.cat([scoremaps[-1], encoding], 1)
            for rec in range(1, 7):
                x = leaky_relu(getattr(self, f"conv{pass_id}_{rec}")(x))
            scoremaps.append(getattr(self, f"conv{pass_id}_7")(x))
        return [_nhwc(s.float()) for s in scoremaps]


def _add_lifting_convs(module: nn.Module, prefix: str, in_channels: int,
                       widths, in_size: int) -> tuple[list, int]:
    """Three (3x3 conv, 3x3 stride-2 conv) pairs named ``<prefix>_<i>_1``
    and ``_2`` on ``module``; returns their names and the width of the
    flattened features with the hand side."""
    names = []
    for i, width in enumerate(widths):
        for j, stride in ((1, 1), (2, 2)):
            names.append(f"{prefix}_{i}_{j}")
            setattr(module, names[-1], TFConv(in_channels, width, 3, stride))
            in_channels = width
    return names, in_channels * same_size(in_size, 2, len(widths)) ** 2 + 2


def _lifting_features(module: nn.Module, scoremap, hand_side):
    """The convs of ``module._names``, the NHWC flatten and the hand side."""
    x = _nchw(scoremap)
    for name in module._names:
        x = leaky_relu(getattr(module, name)(x))
    x = _nhwc(x).reshape(x.shape[0], -1)
    return torch.cat([x, hand_side.float()], 1)


class PosePrior(nn.Module):
    """(B, s, s, 21) scoremaps and (B, 2) hand side -> (B, 21, 3)
    canonical coordinates (reference ColorHandPose3DNetwork.py:311-334;
    bottleneck: PosePriorNetwork.py:97-122).  ``in_size``: s."""

    KEEP = 0.8

    def __init__(self, num_kp: int = 21, bottleneck: bool = False,
                 in_size: int = 32):
        super().__init__()
        self.num_kp, self.bottleneck = num_kp, bottleneck
        self._names, width = _add_lifting_convs(self, "conv_pose", num_kp,
                                                [32, 64, 128], in_size)
        for i in (0, 1):
            setattr(self, f"fc_rel{i}", nn.Linear(width, 512))
            width = 512
        if bottleneck:
            self.fc_bottleneck = nn.Linear(512, 30)
            width = 30
        self.fc_xyz = nn.Linear(width, num_kp * 3)

    def forward(self, scoremap, hand_side, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = _lifting_features(self, scoremap, hand_side)
        for i in (0, 1):
            x = dropout(leaky_relu(getattr(self, f"fc_rel{i}")(x)),
                        self.KEEP, train, generator)
        if self.bottleneck:
            x = self.fc_bottleneck(x)
        return self.fc_xyz(x).reshape(x.shape[0], self.num_kp, 3)


def rot_mat_from_axis_angle(ux, uy, uz) -> torch.Tensor:
    """Rodrigues' rotation matrix of the axis-angle vector u, (B, 1) each
    (reference ColorHandPose3DNetwork.py:376-399): theta = |u| with 1e-8
    under the root."""
    theta = torch.sqrt(ux ** 2 + uy ** 2 + uz ** 2 + 1e-8)[:, 0]
    st, ct = torch.sin(theta), torch.cos(theta)
    one_ct = 1.0 - ct
    ux, uy, uz = ux[:, 0] / theta, uy[:, 0] / theta, uz[:, 0] / theta
    rows = [ct + ux * ux * one_ct, ux * uy * one_ct - uz * st,
            ux * uz * one_ct + uy * st,
            uy * ux * one_ct + uz * st, ct + uy * uy * one_ct,
            uy * uz * one_ct - ux * st,
            uz * ux * one_ct - uy * st, uz * uy * one_ct + ux * st,
            ct + uz * uz * one_ct]
    return torch.stack(rows, -1).reshape(-1, 3, 3)


class ViewpointNet(nn.Module):
    """(B, s, s, 21) scoremaps and (B, 2) hand side -> (B, 3, 3) rotation
    (reference ColorHandPose3DNetwork.py:339-374).  ``in_size``: s."""

    KEEP = 0.75

    def __init__(self, num_kp: int = 21, in_size: int = 32):
        super().__init__()
        self._names, width = _add_lifting_convs(self, "conv_vp", num_kp,
                                                [64, 128, 256], in_size)
        self.fc_vp0 = nn.Linear(width, 256)
        self.fc_vp1 = nn.Linear(256, 128)
        self.fc_vp_ux = nn.Linear(128, 1)
        self.fc_vp_uy = nn.Linear(128, 1)
        self.fc_vp_uz = nn.Linear(128, 1)

    def forward(self, scoremap, hand_side, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = _lifting_features(self, scoremap, hand_side)
        for fc in (self.fc_vp0, self.fc_vp1):
            x = dropout(leaky_relu(fc(x)), self.KEEP, train, generator)
        return rot_mat_from_axis_angle(self.fc_vp_ux(x), self.fc_vp_uy(x),
                                       self.fc_vp_uz(x))


class ColorHandPose3D(nn.Module):
    """The whole pipeline (reference ColorHandPose3DNetwork.py:64-102):
    ``forward(image, hand_side)`` gives the reference ``inference``'s
    6-tuple (hand_scoremap, image_crop, scale_crop, center,
    keypoints_scoremap upsampled to the crop, keypoint_coord3d)."""

    def __init__(self, crop_size: int = 256, num_kp: int = 21):
        super().__init__()
        self.crop_size = crop_size
        size = same_size(crop_size, 2, 3)
        self.HandSegNet = HandSegNet()
        self.PoseNet2D = PoseNet2D(num_kp)
        self.PosePrior = PosePrior(num_kp, in_size=size)
        self.ViewpointNet = ViewpointNet(num_kp, in_size=size)

    def forward(self, image, hand_side, train: bool = False,
                crop_externally: bool = False,
                generator: Optional[torch.Generator] = None):
        hand_scoremap = self.HandSegNet(image)
        # intermediate processing (reference :84-89)
        hand_mask = h3img.single_obj_scoremap(hand_scoremap)
        center, _, crop_size_best = h3img.calc_center_bb(hand_mask)
        scale_crop = torch.clamp(self.crop_size / (crop_size_best * 1.25),
                                 0.25, 5.0)
        if crop_externally:
            # inference_crop (reference :107-144): a tight crop comes in
            image_crop = image.float()
        else:
            image_crop = h3img.crop_image_from_xy(
                image, center, self.crop_size, scale_crop[:, 0])
        keypoints_scoremap = self.PoseNet2D(image_crop)[-1]
        coord3d = self.pose3d(keypoints_scoremap, hand_side, train, generator)
        keypoints_scoremap = h3img.resize_bilinear_tf1(
            keypoints_scoremap, image_crop.shape[1:3])
        return (hand_scoremap, image_crop, scale_crop, center,
                keypoints_scoremap, coord3d)

    def pose3d(self, keypoints_scoremap, hand_side, train: bool = False,
               generator: Optional[torch.Generator] = None):
        """PosePrior, ViewpointNet and the right hand's flip (reference
        :279-305)."""
        coord_can = self.PosePrior(keypoints_scoremap, hand_side, train,
                                   generator)
        rot_mat = self.ViewpointNet(keypoints_scoremap, hand_side, train,
                                    generator)
        coord_flip = flip_right_hand(coord_can, hand_side.argmax(1) == 1)
        return coord_flip @ rot_mat

    def detection(self, image):
        """HandSegNet alone (reference inference_detection)."""
        return self.HandSegNet(image)

    def pose2d(self, image_crop):
        """PoseNet2D alone: its 3 scoremaps at 1/8."""
        return self.PoseNet2D(image_crop)


class PosePriorNetwork(nn.Module):
    """The lifting study's nets (reference PosePriorNetwork.py:30-95):
    ``forward(scoremap, hand_side)`` -> (coord_xyz_rel_normed, coord3d, R),
    the scoremap at the crop's full size (B, S, S, 21), average-pooled 8x8
    "SAME" on entry (reference :61)."""

    def __init__(self, variant: str = "proposed", num_kp: int = 21,
                 crop_size: int = 256):
        super().__init__()
        if variant not in LIFTING_VARIANTS:
            raise ValueError(f"Unknown variant [{variant}]")
        self.variant = variant
        size = same_size(crop_size, 8)
        self.PosePrior = PosePrior(num_kp, bottleneck=variant == "bottleneck",
                                   in_size=size)
        if variant == "proposed":
            self.ViewpointNet = ViewpointNet(num_kp, in_size=size)

    def forward(self, scoremap, hand_side, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = _nchw(scoremap)
        top, bottom = same_pads(x.shape[2], 8, 8)
        left, right = same_pads(x.shape[3], 8, 8)
        # flax's avg_pool counts the padding in its mean
        pooled = _nhwc(F.avg_pool2d(F.pad(x, (left, right, top, bottom)), 8))
        if self.variant in ("direct", "bottleneck"):
            coord3d = self.PosePrior(pooled, hand_side, train, generator)
            return coord3d, coord3d, None
        if self.variant in ("local", "local_w_xyz_loss"):
            coord_rel = self.PosePrior(pooled, hand_side, train, generator)
            return bone_rel_trafo_inv(coord_rel), coord_rel, None
        coord_can = self.PosePrior(pooled, hand_side, train, generator)
        rot_mat = self.ViewpointNet(pooled, hand_side, train, generator)
        # the study's variant does not flip by hand side (commented out in
        # the reference :85-88)
        return coord_can @ rot_mat, coord_can, rot_mat
