"""The depth and voxel GAN baselines, the tail of the baseline zoo
(counterpart of mmhand_tpu/models/voxel_nets.py; reference
baselines/quantitative_on_benchmarks/networks/).

* ``DepthGenerator`` (reference net_depthgenerator.py:1-41): keypoint uv
  (B, 42) -> Linear -> a channels-first 32x4x4 seed -> 5x
  [ConvTranspose2d(k6, s2, p2), BatchNorm, LeakyReLU(0.2)] -> (B, 128, 128,
  1).  The reference's final Tanh is commented out, so the head is
  BatchNorm + LeakyReLU.
* ``DepthDiscriminator`` (reference net_depthdiscriminator.py:1-63): a 1x1
  pixelGAN encoder with three heads: per-pixel logits, 21 heatmaps, and a
  flatten + MLP regressor of 63 keypoint values whose Linear(65536, 256)
  fits only a 256x256 input, which the forward asserts.  The heads apply
  LeakyReLU on both sides of their BatchNorm, as the reference does.
* ``VoxelGenerator`` (reference net_voxelgenerator.py:103-139, blocks.py:
  342-465): the V2V-PoseNet 3-D hourglass, tanh 1-channel voxels.
* ``VoxelDiscriminator`` (reference net_voxeldiscriminator.py:1-55): four
  strided [Conv3d, BatchNorm, LeakyReLU] blocks, 2 channels in, 1 out.

Module names are the reference's torch keys (``front_layers.0.block.0``,
``encoder_decoder.skip_res1.res_branch.0``, ``models.models.<i>``,
``hard_predictor.5``), so a reference ``.pth`` loads with
``load_state_dict`` and mmhand_tpu's ``load_*_state_dict`` read the port's
``state_dict()``; ``convert.*_state_dict_from_jax`` go the other way.

The BatchNorms are the port's ``BatchNorm2d`` and ``BatchNorm3d`` (flax's
biased running variance), so train mode runs K2 and K2b on the card.  The
depth nets take and give NHWC and run ``channels_last`` inside; the voxel
nets take and give NDHWC and run ``channels_last_3d``, the layouts K2
reads.  Move a net with ``.to(memory_format=...)`` of that layout.
"""

from __future__ import annotations

import torch
from torch import nn

from mmhand_torch.models.layers import BatchNorm2d, BatchNorm3d, in_net_dtype

DEPTH_DISCRIMINATOR_SIZE = 256  # the side its Linear(65536, 256) fits


def _lrelu() -> nn.Module:
    return nn.LeakyReLU(0.2)


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    """An NDHWC tensor as the NCDHW view of it, which is channels_last_3d
    when the NDHWC tensor is contiguous."""
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


class Basic3DBlock(nn.Module):
    """Conv3d(k, s 1, p (k-1)/2) + BatchNorm + ReLU (reference
    blocks.py:372-383)."""

    def __init__(self, in_planes: int, out_planes: int, kernel_size: int):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv3d(in_planes, out_planes, kernel_size,
                      padding=(kernel_size - 1) // 2),
            BatchNorm3d(out_planes), nn.ReLU(True))

    def forward(self, x):
        return self.block(x)


class Res3DBlock(nn.Module):
    """Two 3x3x3 conv + BatchNorm with a skip, projected where the width
    changes (reference blocks.py:385-408)."""

    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        self.res_branch = nn.Sequential(
            nn.Conv3d(in_planes, out_planes, 3, padding=1),
            BatchNorm3d(out_planes), nn.ReLU(True),
            nn.Conv3d(out_planes, out_planes, 3, padding=1),
            BatchNorm3d(out_planes))
        self.skip_con = nn.Sequential() if in_planes == out_planes else \
            nn.Sequential(nn.Conv3d(in_planes, out_planes, 1),
                          BatchNorm3d(out_planes))

    def forward(self, x):
        return nn.functional.relu(self.res_branch(x) + self.skip_con(x))


class Pool3DBlock(nn.Module):
    """max_pool3d(k, k) (reference blocks.py:410-416)."""

    def __init__(self, pool_size: int):
        super().__init__()
        self.pool_size = pool_size

    def forward(self, x):
        return nn.functional.max_pool3d(x, self.pool_size, self.pool_size)


class Upsample3DBlock(nn.Module):
    """ConvTranspose3d(k, s) + BatchNorm + ReLU (reference
    blocks.py:418-428)."""

    def __init__(self, in_planes: int, out_planes: int, kernel_size: int,
                 stride: int):
        super().__init__()
        self.block = nn.Sequential(
            nn.ConvTranspose3d(in_planes, out_planes, kernel_size, stride),
            BatchNorm3d(out_planes), nn.ReLU(True))

    def forward(self, x):
        return self.block(x)


class EncoderDecoder3D(nn.Module):
    """The hourglass: two poolings down, two upsamplings back, a skip at
    each level (reference blocks.py:430-465)."""

    def __init__(self):
        super().__init__()
        self.encoder_pool1 = Pool3DBlock(2)
        self.encoder_res1 = Res3DBlock(32, 64)
        self.encoder_pool2 = Pool3DBlock(2)
        self.encoder_res2 = Res3DBlock(64, 128)
        self.mid_res = Res3DBlock(128, 128)
        self.decoder_res2 = Res3DBlock(128, 128)
        self.decoder_upsample2 = Upsample3DBlock(128, 64, 2, 2)
        self.decoder_res1 = Res3DBlock(64, 64)
        self.decoder_upsample1 = Upsample3DBlock(64, 32, 2, 2)
        self.skip_res1 = Res3DBlock(32, 32)
        self.skip_res2 = Res3DBlock(64, 64)

    def forward(self, x):
        skip_x1 = self.skip_res1(x)
        x = self.encoder_res1(self.encoder_pool1(x))
        skip_x2 = self.skip_res2(x)
        x = self.encoder_res2(self.encoder_pool2(x))
        x = self.decoder_res2(self.mid_res(x))
        x = self.decoder_upsample2(x) + skip_x2
        x = self.decoder_upsample1(self.decoder_res1(x)) + skip_x1
        return x


class VoxelGenerator(nn.Module):
    """V2V 3-D hourglass voxel generator (reference
    net_voxelgenerator.py:103-139): (B, D, H, W, 1) with D, H, W divisible
    by 8 -> (B, D, H, W, output_channels), tanh."""

    def __init__(self, input_channels: int = 1, output_channels: int = 1):
        super().__init__()
        self.front_layers = nn.Sequential(
            Basic3DBlock(input_channels, 16, 7), Pool3DBlock(2),
            Res3DBlock(16, 32), Res3DBlock(32, 32), Res3DBlock(32, 32))
        self.encoder_decoder = EncoderDecoder3D()
        self.back_layers = nn.Sequential(
            Res3DBlock(32, 32), Basic3DBlock(32, 32, 1),
            Basic3DBlock(32, 32, 1),
            Upsample3DBlock(32, output_channels, 2, 2))
        self.output_layer = nn.Conv3d(output_channels, output_channels, 3,
                                      padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.front_layers(_ncdhw(in_net_dtype(self, x)))
        x = self.back_layers(self.encoder_decoder(x))
        return _ndhwc(torch.tanh(self.output_layer(x)))


class LeakyConv3dBlocks(nn.Module):
    """[Conv3d(k, s, p, no bias), BatchNorm, LeakyReLU(0.2)] per setting
    (reference net_voxeldiscriminator.py:7-17; its own Sequential, so the
    discriminator's keys are ``models.models.<i>``)."""

    def __init__(self, in_channels: int, settings):
        super().__init__()
        layers = []
        for features, k, s, p in settings:
            layers += [nn.Conv3d(in_channels, features, k, s, p, bias=False),
                       BatchNorm3d(features), _lrelu()]
            in_channels = features
        self.models = nn.Sequential(*layers)

    def forward(self, x):
        return self.models(x)


class VoxelDiscriminator(nn.Module):
    """Four strided Conv3d + BatchNorm + LeakyReLU blocks, 2 channels in ->
    1 out (reference net_voxeldiscriminator.py:19-42): (B, D, H, W, 2) ->
    (B, D', H', W', 1)."""

    SETTINGS = ((64, 3, 2, 1), (128, 3, 2, 1), (256, 3, 2, 1), (1, 4, 3, 1))

    def __init__(self, input_channels: int = 2, settings=SETTINGS):
        super().__init__()
        self.models = LeakyConv3dBlocks(input_channels, settings)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ndhwc(self.models(_ncdhw(in_net_dtype(self, x))))


class DepthGenerator(nn.Module):
    """Keypoints (B, 42) -> (B, 128, 128, 1) depth map (reference
    net_depthgenerator.py:5-30; n_layer 5, n_filter 32)."""

    def __init__(self, input_nc: int = 42, n_layer: int = 5,
                 n_filter: int = 32):
        super().__init__()
        self.n_filter = n_filter
        self.linear = nn.Linear(input_nc, 4 * 4 * n_filter)
        self.models = nn.Sequential(*[
            nn.Sequential(
                nn.ConvTranspose2d(n_filter, 1 if i == n_layer - 1
                                   else n_filter, 6, 2, 2),
                BatchNorm2d(1 if i == n_layer - 1 else n_filter), _lrelu())
            for i in range(n_layer)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the reference's reshape(-1, 32, 4, 4) is channels-first
        x = self.linear(in_net_dtype(self, x)).view(-1, self.n_filter, 4, 4)
        x = self.models(x.contiguous(memory_format=torch.channels_last))
        return x.permute(0, 2, 3, 1)


class DepthDiscriminator(nn.Module):
    """1x1 pixelGAN with classification, heatmap and keypoint heads
    (reference net_depthdiscriminator.py:5-58): (B, 256, 256, input_nc) ->
    (logits (B, 256, 256, 1), heatmaps (B, 256, 256, 21), keypoints
    (B, 63))."""

    def __init__(self, input_nc: int = 1, ndf: int = 64,
                 n_keypoints: int = 21):
        super().__init__()
        side = DEPTH_DISCRIMINATOR_SIZE
        self.encoder = nn.Sequential(
            nn.Conv2d(input_nc, ndf, 1), _lrelu(),
            nn.Conv2d(ndf, ndf * 2, 1, bias=False), BatchNorm2d(ndf * 2),
            _lrelu())
        self.classifier = nn.Conv2d(ndf * 2, 1, 1, bias=False)
        self.predictor = nn.Sequential(
            nn.Conv2d(ndf * 2, n_keypoints, 1, bias=False), _lrelu(),
            BatchNorm2d(n_keypoints), _lrelu())
        self.hard_predictor = nn.Sequential(
            nn.Conv2d(ndf * 2, 1, 1, bias=False), _lrelu(), BatchNorm2d(1),
            _lrelu(), nn.Flatten(), nn.Linear(side * side, 256),
            nn.Linear(256, 3 * n_keypoints))

    def forward(self, x: torch.Tensor):
        side = DEPTH_DISCRIMINATOR_SIZE
        if tuple(x.shape[1:3]) != (side, side):
            raise ValueError(f"DepthDiscriminator takes {side}x{side} input "
                             f"(its Linear({side * side}, 256)), got "
                             f"{tuple(x.shape[1:3])}")
        h = self.encoder(in_net_dtype(self, x).permute(0, 3, 1, 2))
        # the hard head's map has one channel, so its NCHW flatten is the
        # same order as mmhand_tpu's NHWC one
        return (self.classifier(h).permute(0, 2, 3, 1),
                self.predictor(h).permute(0, 2, 3, 1),
                self.hard_predictor(h))
