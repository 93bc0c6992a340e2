"""ResNet-style discriminator (counterpart of
mmhand_tpu/models/discriminator.py; reference models/Discriminator.py:8-155).

ReflectPad3 + Conv7(ndf) -> stride-2 downsamples (2 by default, or the
special-cased 3-downsample stack, reference :100-133) -> ``n_blocks``
ResnetBlocks.  The stem is always reflect-padded; the downsampling convs pad
with zeros in the conv; the ResnetBlocks pad as ``pad_mode`` says.

Deliberately preserved reference quirk: there is **no final 1-channel
projection**.  The "logits" are the full ndf*4-channel feature map, which the
GAN loss compares with an expanded scalar target (reference
models/network_utils.py:143-163).

The network is one flat ``nn.Sequential`` with the reference's indices, and a
ResnetBlock keeps its layers in ``conv_block``, so the ``state_dict`` reads
``<idx>.weight`` and ``<idx>.conv_block.<j>.weight``: the layout
tools/convert_mmhand_torch.py ``convert_discriminator`` parses, once
``utils.checkpoint.load_state_dict`` has stripped the reference's ``model.``
prefix.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmhand_torch.models.layers import (
    NormConfig,
    conv_norm_relu,
    norm_layer,
    pad_conv,
)


class ResnetBlock(nn.Module):
    """pad->conv->norm->relu->[dropout]->pad->conv->norm, plus the input
    (reference Discriminator.py:8-55)."""

    def __init__(self, dim: int, norm: NormConfig, use_dropout: bool,
                 pad_mode: str = "reflect"):
        super().__init__()
        layers = conv_norm_relu(dim, dim, 3, norm, pad=1, pad_mode=pad_mode)
        if use_dropout:
            layers.append(nn.Dropout(0.5))
        layers += pad_conv(dim, dim, 3, pad=1, pad_mode=pad_mode,
                           use_bias=norm.use_bias)
        layers.append(norm_layer(norm, dim))
        self.conv_block = nn.Sequential(*layers)

    def forward(self, x):
        return x + self.conv_block(x)


def _down_widths(ndf: int, n_downsampling: int) -> list[int]:
    if n_downsampling <= 2:
        return [ndf * 2 ** (i + 1) for i in range(n_downsampling)]
    if n_downsampling == 3:
        # the third downsample keeps the width at ndf*4 (reference :100-133)
        return [ndf * 2, ndf * 4, ndf * 4]
    raise NotImplementedError(f"n_downsampling={n_downsampling} unsupported")


class Discriminator(nn.Sequential):
    """Input NHWC in [-1, 1]; output NHWC feature-map logits, float32.  With
    ``compute_dtype`` bf16 or fp16 the network runs under ``torch.autocast``
    in that type with f32 parameters; with None it runs in f32."""

    def __init__(self, input_nc: int, ndf: int = 64, n_blocks: int = 3,
                 n_downsampling: int = 2, norm: NormConfig = NormConfig(),
                 use_dropout: bool = True, pad_mode: str = "reflect",
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16):
        layers = conv_norm_relu(input_nc, ndf, 7, norm, pad=3,
                                pad_mode="reflect")
        width = ndf
        for out in _down_widths(ndf, n_downsampling):
            layers += conv_norm_relu(width, out, 3, norm, stride=2, pad=1,
                                     zero_pad_in_conv=True)
            width = out
        layers += [ResnetBlock(width, norm, use_dropout, pad_mode)
                   for _ in range(n_blocks)]
        super().__init__(*layers)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        # NHWC -> NCHW view: a contiguous NHWC tensor is channels_last NCHW
        x = x.permute(0, 3, 1, 2)
        dtype = self.compute_dtype
        with torch.autocast(x.device.type, dtype=dtype,
                            enabled=dtype is not None):
            x = super().forward(x)
        return x.permute(0, 2, 3, 1).float()
