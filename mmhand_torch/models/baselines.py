"""Baseline generators of the jointsmap-conditioned judges (counterpart of
mmhand_tpu/models/baselines.py, reference baselines/quantitative_on_benchmarks/
networks/networks.py):

* ResnetGenerator: CycleGAN's (networks.py:365-426; bench_cyclegan.py).
* UnetGenerator: pix2pix's recursive skip UNet (networks.py:486-588;
  bench_p2p.py).
* PATN2Stream: the 2-stream Pose-Attentional-Transfer generator of
  PoseTransfer (model_variants.py:8-170; bench_poseTransfer.py), the
  MM-Hand generator without its depth stream.
* NLayerDiscriminator and PixelDiscriminator: pix2pix's PatchGANs
  (networks.py:591-686).
* PoseResNet: the SimpleBaselines pose network (networks.py:686-990).

Each keeps the reference's torch state_dict layout.  The ResnetGenerator is
one flat ``nn.Sequential`` (keys ``<i>.weight``,
``<i>.conv_block.<j>.weight``), the layout tools/convert_baselines_torch.py
parses; the UnetGenerator nests one ``model`` Sequential per level (keys
``model.model.<i>``, ``model.model.1.model.<i>``, ...); the PatchGANs are
flat Sequentials (the reference's ``model.<i>`` and ``net.<i>`` without the
wrapper's prefix); PATN2Stream has the reference's ``stream1_down``,
``stream2_down``, ``att.<b>.conv_block_stream{1,2}`` and ``stream1_up``;
PoseResNet its ``conv1``, ``layer<s>.<b>.conv<c>``, ``downsample.{0,1}``,
``deconv_layers.<i>`` and ``final_layer``.  Inputs and outputs are NHWC;
``compute_dtype`` bf16 or fp16 runs a network under ``torch.autocast`` with
f32 parameters, None runs it in f32.  Every BatchNorm is the port's
``layers.BatchNorm2d``, so a train-mode forward on the card takes its
moments from kernel K2 (and K2b in the backward), and its running variance
folds the biased batch variance, as flax's BatchNorm does.

One deliberate difference from the reference torch code, kept from
mmhand_tpu: the UNet's down LeakyReLU is not in place, so the skip
connection carries the level's input, not its activation.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from mmhand_torch.models.discriminator import ResnetBlock
from mmhand_torch.models.generator import _att_conv_block, down_stem, up_path
from mmhand_torch.models.layers import (
    BatchNorm2d,
    NormConfig,
    conv_norm_relu,
    norm_layer,
    pad_conv,
    up_conv,
)


def _nhwc_forward(net: nn.Module, body, x: torch.Tensor) -> torch.Tensor:
    # NHWC -> NCHW view: a contiguous NHWC tensor is channels_last NCHW
    x = x.permute(0, 3, 1, 2)
    dtype = net.compute_dtype
    with torch.autocast(x.device.type, dtype=dtype, enabled=dtype is not None):
        x = body(x)
    return x.permute(0, 2, 3, 1).float()


class ResnetGenerator(nn.Sequential):
    """CycleGAN resnet generator (reference networks.py:365-426): reflect-pad
    conv7, stride-2 downsamplings, ResnetBlocks, transposed-conv
    upsamplings, reflect-pad conv7, tanh."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 64,
                 n_blocks: int = 6, n_downsampling: int = 2,
                 norm: NormConfig = NormConfig(), use_dropout: bool = False,
                 pad_mode: str = "reflect",
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16):
        layers = conv_norm_relu(input_nc, ngf, 7, norm, pad=3,
                                pad_mode="reflect")
        for i in range(n_downsampling):
            mult = 2 ** i
            layers += conv_norm_relu(ngf * mult, ngf * mult * 2, 3, norm,
                                     stride=2, pad=1, zero_pad_in_conv=True)
        width = ngf * 2 ** n_downsampling
        layers += [ResnetBlock(width, norm, use_dropout, pad_mode)
                   for _ in range(n_blocks)]
        for i in range(n_downsampling):
            layers += [up_conv(width, width // 2, use_bias=norm.use_bias),
                       norm_layer(norm, width // 2), nn.ReLU(True)]
            width //= 2
        layers += pad_conv(ngf, output_nc, 7, pad=3, pad_mode="reflect")
        layers.append(nn.Tanh())
        super().__init__(*layers)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return _nhwc_forward(self, super().forward, x)


class UnetSkipBlock(nn.Module):
    """One UNet level (reference networks.py:518-588 UnetSkipConnectionBlock):
    down [leaky relu] conv4 s2 [norm]; the submodule; up relu convT4 s2 and
    norm, or tanh at the outermost level; every level but the outermost
    returns cat(input, up)."""

    def __init__(self, outer_nc: int, inner_nc: int,
                 submodule: Optional["UnetSkipBlock"] = None,
                 outermost: bool = False, innermost: bool = False,
                 norm: NormConfig = NormConfig(), use_dropout: bool = False,
                 input_nc: Optional[int] = None):
        super().__init__()
        self.outermost = outermost
        # the down conv has no bias under batch norm, the outermost too
        down_conv = nn.Conv2d(input_nc or outer_nc, inner_nc, 4, stride=2,
                              padding=1, bias=norm.use_bias)
        up_in = inner_nc if innermost else inner_nc * 2
        up = up_conv(up_in, outer_nc, use_bias=norm.use_bias or outermost,
                     kernel=4, output_padding=0)
        if outermost:
            layers = [down_conv, submodule, nn.ReLU(True), up, nn.Tanh()]
        elif innermost:
            layers = [nn.LeakyReLU(0.2), down_conv, nn.ReLU(True), up,
                      norm_layer(norm, outer_nc)]
        else:
            layers = [nn.LeakyReLU(0.2), down_conv, norm_layer(norm, inner_nc),
                      submodule, nn.ReLU(True), up, norm_layer(norm, outer_nc)]
            if use_dropout:
                layers.append(nn.Dropout(0.5))
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        if self.outermost:
            return self.model(x)
        return torch.cat([x, self.model(x)], 1)


class UnetGenerator(nn.Module):
    """pix2pix UNet (reference networks.py:486-515): ``num_downs`` levels,
    widths ngf -> 2 ngf -> 4 ngf -> 8 ngf, then 8 ngf repeated."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3,
                 num_downs: int = 8, ngf: int = 64,
                 norm: NormConfig = NormConfig(), use_dropout: bool = False,
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16):
        super().__init__()
        block = UnetSkipBlock(ngf * 8, ngf * 8, innermost=True, norm=norm)
        for _ in range(num_downs - 5):
            block = UnetSkipBlock(ngf * 8, ngf * 8, block, norm=norm,
                                  use_dropout=use_dropout)
        block = UnetSkipBlock(ngf * 4, ngf * 8, block, norm=norm)
        block = UnetSkipBlock(ngf * 2, ngf * 4, block, norm=norm)
        block = UnetSkipBlock(ngf, ngf * 2, block, norm=norm)
        self.model = UnetSkipBlock(output_nc, ngf, block, outermost=True,
                                   norm=norm, input_nc=input_nc)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return _nhwc_forward(self, self.model, x)


class NLayerDiscriminator(nn.Sequential):
    """70x70 PatchGAN (reference networks/net_nlayerdiscriminator.py,
    networks.py:591-636): a stride-2 conv4, then ``n_layers`` conv4s
    widening to at most 8 ndf, each with norm and LeakyReLU(0.2) (the last
    at stride 1), then a conv4 to 1 channel."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 norm: NormConfig = NormConfig(),
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16):
        layers = [nn.Conv2d(input_nc, ndf, 4, stride=2, padding=1),
                  nn.LeakyReLU(0.2)]
        mult = 1
        for n in range(1, n_layers + 1):
            prev, mult = mult, min(2 ** n, 8)
            layers += [nn.Conv2d(ndf * prev, ndf * mult, 4,
                                 stride=2 if n < n_layers else 1, padding=1,
                                 bias=norm.use_bias),
                       norm_layer(norm, ndf * mult), nn.LeakyReLU(0.2)]
        layers.append(nn.Conv2d(ndf * mult, 1, 4, padding=1))
        super().__init__(*layers)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return _nhwc_forward(self, super().forward, x)


class PixelDiscriminator(nn.Sequential):
    """1x1 PatchGAN (reference networks/net_pixeldiscriminator.py,
    networks.py:639-686): conv1x1, LeakyReLU, conv1x1 to 2 ndf, norm,
    LeakyReLU, conv1x1 to 1 channel (with a bias, as mmhand_tpu's)."""

    def __init__(self, input_nc: int = 3, ndf: int = 64,
                 norm: NormConfig = NormConfig(),
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16):
        super().__init__(
            nn.Conv2d(input_nc, ndf, 1), nn.LeakyReLU(0.2),
            nn.Conv2d(ndf, ndf * 2, 1, bias=norm.use_bias),
            norm_layer(norm, ndf * 2), nn.LeakyReLU(0.2),
            nn.Conv2d(ndf * 2, 1, 1))
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return _nhwc_forward(self, super().forward, x)


class PATBlock2(nn.Module):
    """2-stream pose-attention block (reference model_variants.py:8-69): the
    pose stream's sigmoid gates the image stream's residual, and the pose
    stream goes on as cat(its logits, the block's output)."""

    def __init__(self, dim: int, cated_stream2: bool, norm: NormConfig,
                 use_dropout: bool, pad_mode: str = "reflect"):
        super().__init__()
        self.conv_block_stream1 = _att_conv_block(
            dim, False, False, norm, use_dropout, pad_mode)
        self.conv_block_stream2 = _att_conv_block(
            dim, cated_stream2, True, norm, use_dropout, pad_mode)

    def forward(self, x1, x2):
        x1_out = self.conv_block_stream1(x1)
        x2_out = self.conv_block_stream2(x2)
        out = x1 + x1_out * torch.sigmoid(x2_out)
        return out, torch.cat([x2_out, out], dim=1)


class PATN2Stream(nn.Module):
    """2-stream PATN generator (reference model_variants.py:71-170;
    bench_poseTransfer builds G([3, 42], 3, 64, batch norm, dropout, 9
    blocks)).  Input: (image (B,H,W,3), pose (B,H,W,42) = cat(P1, P2)),
    NHWC in [-1, 1]; output (B,H,W,output_nc) float32 tanh image."""

    def __init__(self, input_nc: Sequence[int] = (3, 42), output_nc: int = 3,
                 ngf: int = 64, n_blocks: int = 9, n_downsampling: int = 2,
                 norm: NormConfig = NormConfig(), use_dropout: bool = True,
                 pad_mode: str = "reflect",
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.stream1_down = down_stem(input_nc[0], ngf, n_downsampling, norm)
        self.stream2_down = down_stem(input_nc[1], ngf, n_downsampling, norm)
        dim = ngf * (2 ** n_downsampling)
        self.att = nn.ModuleList(
            PATBlock2(dim, cated_stream2=(i != 0), norm=norm,
                      use_dropout=use_dropout, pad_mode=pad_mode)
            for i in range(n_blocks))
        self.stream1_up = up_path(ngf, output_nc, n_downsampling, norm)

    def forward(self, inputs):
        # NHWC -> NCHW views: a contiguous NHWC tensor is channels_last NCHW
        x1, x2 = (x.permute(0, 3, 1, 2) for x in inputs)
        dtype = self.compute_dtype
        with torch.autocast(x1.device.type, dtype=dtype,
                            enabled=dtype is not None):
            x1 = self.stream1_down(x1)
            x2 = self.stream2_down(x2)
            for block in self.att:
                x1, x2 = block(x1, x2)
            x1 = torch.tanh(self.stream1_up(x1))
        return x1.permute(0, 2, 3, 1).float()


# (bottleneck blocks, blocks per stage) — reference networks.py:964-968
POSE_RESNET_SPEC = {18: (False, [2, 2, 2, 2]),
                    34: (False, [3, 4, 6, 3]),
                    50: (True, [3, 4, 6, 3]),
                    101: (True, [3, 4, 23, 3]),
                    152: (True, [3, 8, 36, 3])}


class _ResnetBackboneBlock(nn.Module):
    """BasicBlock (expansion 1) or Bottleneck (expansion 4) of the backbone
    (reference networks.py:686-758), with ``downsample`` = (conv1x1, bn)
    where the shape changes."""

    def __init__(self, in_planes: int, planes: int, stride: int,
                 bottleneck: bool, has_downsample: bool):
        super().__init__()
        widths = ([(in_planes, planes, 1, 1), (planes, planes, 3, stride),
                   (planes, planes * 4, 1, 1)] if bottleneck else
                  [(in_planes, planes, 3, stride), (planes, planes, 3, 1)])
        for c, (cin, cout, k, s) in enumerate(widths, 1):
            setattr(self, f"conv{c}", nn.Conv2d(cin, cout, k, stride=s,
                                                padding=k // 2, bias=False))
            setattr(self, f"bn{c}", BatchNorm2d(cout))
        self.n_convs = len(widths)
        self.downsample = nn.Sequential(
            nn.Conv2d(in_planes, widths[-1][1], 1, stride=stride, bias=False),
            BatchNorm2d(widths[-1][1])) if has_downsample else None

    def forward(self, x):
        h = x
        for c in range(1, self.n_convs + 1):
            h = getattr(self, f"bn{c}")(getattr(self, f"conv{c}")(h))
            if c < self.n_convs:
                h = torch.relu(h)
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(h + residual)


class PoseResNet(nn.Module):
    """SimpleBaselines pose network: a ResNet backbone, 3 deconvolutions and
    a 1x1 joint-heatmap head (reference networks.py:801-990, built by
    define_poseNet with --resnet_size).  The POSE_RESNET extras the
    reference expects injected are SimpleBaselines' defaults, as in
    mmhand_tpu: 3 deconvs of 256 filters, kernel 4 (ConvTranspose2d k4 s2
    p1 op0), no deconv bias, a 1x1 final conv.  Input (B,H,W,3) NHWC;
    output (B,H/4,W/4,num_joints) float32."""

    def __init__(self, num_joints: int = 21, resnet_size: int = 50,
                 deconv_filters: Sequence[int] = (256, 256, 256),
                 deconv_kernels: Sequence[int] = (4, 4, 4),
                 final_conv_kernel: int = 1, deconv_with_bias: bool = False,
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        bottleneck, layers = POSE_RESNET_SPEC[resnet_size]
        expansion = 4 if bottleneck else 1
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_planes = 64
        for stage, (planes, blocks) in enumerate(
                zip([64, 128, 256, 512], layers)):
            seq = []
            for b in range(blocks):
                s = (1 if stage == 0 else 2) if b == 0 else 1
                seq.append(_ResnetBackboneBlock(
                    in_planes, planes, s, bottleneck,
                    has_downsample=(b == 0 and (
                        s != 1 or in_planes != planes * expansion))))
                in_planes = planes * expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*seq))
        deconvs = []
        for f, k in zip(deconv_filters, deconv_kernels):
            pad, op = {4: (1, 0), 3: (1, 1), 2: (0, 0)}[k]
            deconvs += [nn.ConvTranspose2d(in_planes, f, k, stride=2,
                                           padding=pad, output_padding=op,
                                           bias=deconv_with_bias),
                        BatchNorm2d(f), nn.ReLU()]
            in_planes = f
        self.deconv_layers = nn.Sequential(*deconvs)
        self.final_layer = nn.Conv2d(
            in_planes, num_joints, final_conv_kernel,
            padding=1 if final_conv_kernel == 3 else 0)

    def body(self, x):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
        return self.final_layer(self.deconv_layers(x))

    def forward(self, x):
        return _nhwc_forward(self, self.body, x)


def load_pose_resnet_state_dict(sd, resnet_size: int = 50,
                                **kwargs) -> PoseResNet:
    """A PoseResNet of ``resnet_size`` holding a reference (or port) torch
    state_dict of tensors or arrays, loaded strictly: the keys are the
    reference's as they stand, after DataParallel's ``module.``.  A
    BatchNorm without ``num_batches_tracked`` (checkpoints of torch before
    0.4.1) gets 0."""
    net = PoseResNet(resnet_size=resnet_size, **kwargs)
    sd = {k.removeprefix("module."): torch.as_tensor(np.asarray(v))
          for k, v in sd.items()}
    for key in net.state_dict():
        if key.endswith("num_batches_tracked"):
            sd.setdefault(key, torch.tensor(0, dtype=torch.long))
    net.load_state_dict(sd)
    return net
