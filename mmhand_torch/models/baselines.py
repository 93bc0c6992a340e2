"""Baseline generators of the jointsmap-conditioned judges (counterpart of
mmhand_tpu/models/baselines.py, reference baselines/quantitative_on_benchmarks/
networks/networks.py):

* ResnetGenerator: CycleGAN's (networks.py:365-426; bench_cyclegan.py).
* UnetGenerator: pix2pix's recursive skip UNet (networks.py:486-588;
  bench_p2p.py).

Both keep the reference's torch state_dict layout, which
tools/convert_baselines_torch.py parses: the ResnetGenerator is one flat
``nn.Sequential`` (keys ``<i>.weight``, ``<i>.conv_block.<j>.weight``), the
UnetGenerator nests one ``model`` Sequential per level (keys
``model.model.<i>``, ``model.model.1.model.<i>``, ...).  Inputs and outputs
are NHWC; ``compute_dtype`` bf16 or fp16 runs the network under
``torch.autocast`` with f32 parameters, None runs it in f32.

One deliberate difference from the reference torch code, kept from
mmhand_tpu: the UNet's down LeakyReLU is not in place, so the skip
connection carries the level's input, not its activation.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmhand_torch.models.discriminator import ResnetBlock
from mmhand_torch.models.layers import (
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
