"""3-stream pose-attention generator, PATN variant (counterpart of
mmhand_tpu/models/generator.py; reference models/Generator.py:8-313).

* three downsample stems, ``stream{1,2,3}_down``: image (3 ch), pose (42 ch =
  source + target 21-keypoint heatmaps), depth (6 ch = source + target depth
  planes): ReflectPad3 + Conv7, then ``n_downsampling`` stride-2 Conv3
  doublings (reference :158-223);
* ``n_blocks`` PATBlocks at ngf*4 channels, ``att.<b>`` (9 in the reference,
  hardcoded at MMHandModel.py:156);
* ``stream1_up``: 2x ConvTranspose doublings, then ReflectPad3 + Conv7, then
  tanh (reference :240-259).

The submodule names and ``nn.Sequential`` indices are the reference torch
layout, so ``tools/convert_mmhand_torch.py`` reads this module's
``state_dict`` and a reference checkpoint loads into it as it is.

Deliberately preserved reference quirk: a PATBlock returns
``(out, x3_cat, x2_cat)`` and the loop unpacks ``x1, x2, x3``, so the pose and
depth streams swap every block (reference :130,277-278).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mmhand_torch.models.layers import (
    NormConfig,
    conv_norm_relu,
    norm_layer,
    pad_conv,
    up_conv,
)


def _att_conv_block(dim: int, cated: bool, cal_att: bool, norm: NormConfig,
                    use_dropout: bool, pad_mode: str) -> nn.Sequential:
    """One PATBlock stream: pad->conv->norm->relu->[dropout]->pad->conv[->norm].

    cal_att (pose/depth streams) ends with the conv that projects to ``dim``
    and no norm: the sigmoid attention head (reference Generator.py:90-106).
    The image stream ends conv->norm (reference :107-111).  From the second
    block on, the attention streams take ``cat(att_logits, out)``, twice as
    wide (``cated``)."""
    width = dim * 2 if (cated and cal_att) else dim
    layers = conv_norm_relu(width, width, 3, norm, pad=1, pad_mode=pad_mode)
    if use_dropout:
        layers.append(nn.Dropout(0.5))
    layers += pad_conv(width, dim, 3, pad=1, pad_mode=pad_mode,
                       use_bias=norm.use_bias)
    if not cal_att:
        layers.append(norm_layer(norm, dim))
    return nn.Sequential(*layers)


def down_stem(in_nc: int, ngf: int, n_downsampling: int,
              norm: NormConfig) -> nn.Sequential:
    """A stream's downsampling stem: ReflectPad3 + Conv7 to ``ngf``, then
    ``n_downsampling`` stride-2 Conv3 doublings (reference :158-223)."""
    layers = conv_norm_relu(in_nc, ngf, 7, norm, pad=3, pad_mode="reflect")
    for i in range(n_downsampling):
        mult = 2 ** i
        layers += conv_norm_relu(ngf * mult, ngf * mult * 2, 3, norm,
                                 stride=2, pad=1, zero_pad_in_conv=True)
    return nn.Sequential(*layers)


def up_path(ngf: int, output_nc: int, n_downsampling: int,
            norm: NormConfig) -> nn.Sequential:
    """The image stream's way up: [ConvTranspose, norm, relu] per level,
    then ReflectPad3 + Conv7 to ``output_nc`` (reference :240-259; the tanh
    follows in the forward)."""
    up = []
    for i in range(n_downsampling):
        mult = 2 ** (n_downsampling - i)
        up += [up_conv(ngf * mult, ngf * mult // 2, norm.use_bias),
               norm_layer(norm, ngf * mult // 2), nn.ReLU(True)]
    # the final conv keeps its bias (reference :257 has no bias kwarg)
    up += pad_conv(ngf, output_nc, 7, pad=3, pad_mode="reflect",
                   use_bias=True)
    return nn.Sequential(*up)


class PATBlock(nn.Module):
    """Pose-attention block (reference models/Generator.py:8-130)."""

    def __init__(self, dim: int, cated_stream2: bool, norm: NormConfig,
                 use_dropout: bool, pad_mode: str = "reflect"):
        super().__init__()
        self.conv_block_stream1 = _att_conv_block(
            dim, False, False, norm, use_dropout, pad_mode)
        self.conv_block_stream2 = _att_conv_block(
            dim, cated_stream2, True, norm, use_dropout, pad_mode)
        self.conv_block_stream3 = _att_conv_block(
            dim, cated_stream2, True, norm, use_dropout, pad_mode)

    def forward(self, x1, x2, x3):
        x1_out = self.conv_block_stream1(x1)
        x2_out = self.conv_block_stream2(x2)
        x3_out = self.conv_block_stream3(x3)
        att_pose = torch.sigmoid(x2_out)
        att_depth = torch.sigmoid(x3_out)
        out = x1 + x1_out * att_pose * att_depth  # residual (reference :125)
        # feedback cat(att_logits, out), returned x3 before x2: the swap
        x2_cat = torch.cat([x2_out, out], dim=1)
        x3_cat = torch.cat([x3_out, out], dim=1)
        return out, x3_cat, x2_cat


class Generator(nn.Module):
    """PATN 3-stream generator (reference models/Generator.py:133-313).

    Input: tuple (image (B,H,W,3), pose (B,H,W,42), depth (B,H,W,6)), NHWC in
    [-1, 1].  Output: (B,H,W,output_nc) float32 tanh image.  With
    ``compute_dtype`` bf16 or fp16 the network runs under ``torch.autocast``
    in that type with f32 parameters; with None it runs in f32.
    """

    def __init__(self, input_nc: Sequence[int] = (3, 42, 6),
                 output_nc: int = 3, ngf: int = 64, n_blocks: int = 9,
                 n_downsampling: int = 2, norm: NormConfig = NormConfig(),
                 use_dropout: bool = True, pad_mode: str = "reflect",
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype

        self.stream1_down = down_stem(input_nc[0], ngf, n_downsampling, norm)
        self.stream2_down = down_stem(input_nc[1], ngf, n_downsampling, norm)
        self.stream3_down = down_stem(input_nc[2], ngf, n_downsampling, norm)

        dim = ngf * (2 ** n_downsampling)
        self.att = nn.ModuleList(
            PATBlock(dim, cated_stream2=(i != 0), norm=norm,
                     use_dropout=use_dropout, pad_mode=pad_mode)
            for i in range(n_blocks))

        self.stream1_up = up_path(ngf, output_nc, n_downsampling, norm)

    def forward(self, inputs):
        # NHWC -> NCHW views: a contiguous NHWC tensor is channels_last NCHW
        x1, x2, x3 = (x.permute(0, 3, 1, 2) for x in inputs)
        dtype = self.compute_dtype
        with torch.autocast(x1.device.type, dtype=dtype,
                            enabled=dtype is not None):
            x1 = self.stream1_down(x1)
            x2 = self.stream2_down(x2)
            x3 = self.stream3_down(x3)
            for block in self.att:
                x1, x2, x3 = block(x1, x2, x3)
            x1 = torch.tanh(self.stream1_up(x1))
        return x1.permute(0, 2, 3, 1).float()
